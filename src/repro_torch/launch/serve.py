"""Serving launcher of the port: prefill a batch of prompts, then
greedy-decode — port of ``repro.launch.serve`` without its SVM options.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 4 --prompt-len 16 --decode 16

``--arch`` takes every ported config (gemma3-1b, falcon-mamba-7b).

It runs on CUDA unless given ``--device cpu``. Prefill and decode are timed
with CUDA events on the card and with ``time.perf_counter`` on the CPU.
The SVM weight stream (``--svm-*``, ``--requests``, ``--chaos``…) comes
with a later slice (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.bridge import init_params
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step


class _Timer:
    """Milliseconds of device work between ``start`` and ``stop``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1e3


def prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The reference launcher's prompts: ``SyntheticLM(seed=1)``, step 0."""
    data = SyntheticLM(vocab=cfg.vocab, seed=1)
    toks = data.batch(0, 0, batch, prompt_len)["tokens"]
    return torch.from_numpy(toks).to(device)


def run_prefill(cfg, params, tokens: torch.Tensor, impl: str = "auto"):
    """Prefill ``tokens`` (B,S) -> (first greedy token (B,1), last-position
    logits (B,1,V), cache, ms)."""
    timer = _Timer(tokens.device)
    timer.start()
    logits, cache = make_prefill_step(cfg, impl)(params, tokens)
    tok = logits[:, -1].argmax(dim=-1).int()[:, None]
    return tok, logits, cache, timer.stop()


def decode_tokens(serve_step, params, tok, cache, steps: int):
    """Greedy-decode ``steps`` tokens through a serve step. Returns
    (decoded token list, final cache). Decoder-only: the reference's
    context threading for VLM and encoder-decoder archs comes with ROADMAP
    Queue 1 item 8."""
    outs = []
    for _ in range(steps):
        tok, cache = serve_step(params, tok, cache)
        outs.append(tok)
    return outs, cache


def run_decode(cfg, params, tok, cache, steps: int, impl: str = "auto"):
    """Greedy-decode ``steps`` tokens after ``tok`` -> (tokens, cache, ms)."""
    timer = _Timer(tok.device)
    timer.start()
    outs, cache = decode_tokens(make_serve_step(cfg, impl), params, tok,
                                cache, steps)
    return outs, cache, timer.stop()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, seed=0, device=device)
    toks = prompts(cfg, args.batch, args.prompt_len, device)
    with torch.inference_mode():
        tok, _, cache, t_pre = run_prefill(cfg, params, toks)
        decoded, cache, t_dec = run_decode(cfg, params, tok, cache,
                                           args.decode)
    seq = torch.cat([tok] + decoded, dim=1)
    print(f"prefill {args.batch}x{args.prompt_len} in {t_pre:.1f}ms; "
          f"decoded {args.decode} tokens in {t_dec:.1f}ms "
          f"({args.batch * args.decode / max(t_dec / 1e3, 1e-9):.1f} tok/s) "
          f"on {device}")
    print("first request continuation:", seq[0].tolist())


if __name__ == "__main__":
    main()
