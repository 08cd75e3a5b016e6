"""Serving launcher of the port: prefill a batch of prompts, then
greedy-decode — port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 4 --prompt-len 16 --decode 16

``--arch`` takes every ported config (gemma3-1b, falcon-mamba-7b).

It runs on CUDA unless given ``--device cpu``. Prefill and decode are timed
with CUDA events on the card and with ``time.perf_counter`` on the CPU.

With ``--svm-budget-frac`` the decode loop additionally rides the SVM
weight-streaming runtime (`repro_torch.svm`): the model's parameter leaves
are planned into managed ranges against a device pool of the given
fraction of total param bytes, and the whole decode's layer-fetch trace
replays through the compiled-session engine in one fused pass
(`StreamingExecutor.decode_steps`; prefetch modes fall back to per-token
`decode_step` replays), after the timed loop, so tok/s stays the real
number. It reports the simulated streaming wall clock,
migration/eviction traffic and session cache stats next to the real
tok/s.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --svm-budget-frac 0.6 --svm-mode svm_aware --svm-policy lrf
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bridge import init_params, leaves
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.svm import StreamingExecutor

SVM_POLICIES = ("lrf", "lru", "clock", "random")
SVM_MODES = ("naive", "svm_aware", "measured", "zero_copy")


class WeightStream:
    """SVM weight-streaming accounting riding along a real decode loop.

    Each parameter leaf is one fetch group, visited in model order
    (`repro_torch.bridge.leaves`) once per token; per-leaf decode FLOPs are
    estimated as 2 · batch · params. All manager driving goes through the
    executor's `TraceSession` — the per-token trace compiles once and
    replays as cached segments. ``executor_kw`` goes to the
    `StreamingExecutor` (its ``device``, ``cost_params``,
    ``compute_rate``, ``scalar``)."""

    def __init__(self, params, batch: int, *, budget_frac: float,
                 policy: str, mode: str, **executor_kw):
        paths, nbytes, nparams = [], [], []
        for path, leaf in leaves(params):
            paths.append(path)
            n = leaf.numel()
            nparams.append(n)
            nbytes.append(n * leaf.element_size())
        total = sum(nbytes)
        budget = max(int(total * budget_frac), 1)

        kw: dict = {}
        if mode == "svm_aware":
            # pin the embedding-ish hottest leaf (only if it leaves room
            # for streaming the rest — a pinned-full pool deadlocks every
            # later migration) and prefetch the rest
            hot = int(np.argmax(nbytes))
            kw = {"prefetch": True}
            if nbytes[hot] <= budget // 2:
                kw["pin"] = (paths[hot],)
        elif mode == "measured":
            # docs/prefetching.md: profile the first token's touch
            # columns and pin only leaves above the touch-frequency
            # threshold
            kw = {"prefetch_mode": "measured"}
        elif mode == "zero_copy":
            # paper §4.2 hybrid placement: coldest (largest) leaves stay
            # host-resident at remote-access cost, up to half the weights
            order = sorted(range(len(paths)), key=lambda i: -nbytes[i])
            zc, acc = [], 0
            for i in order:
                if acc + nbytes[i] > total // 2:
                    continue     # too big for the budget; smaller may fit
                zc.append(paths[i])
                acc += nbytes[i]
            kw = {"zero_copy": tuple(zc)}

        self.executor = StreamingExecutor(
            params, budget, policy=policy, profile=False, **kw,
            **executor_kw)
        self.layer_paths = [[p] for p in paths]
        self.flops = [2.0 * batch * n for n in nparams]
        self.total_bytes = total
        self.budget = budget

    def step(self) -> None:
        self.executor.decode_step(self.layer_paths, self.flops,
                                  materialize=False)

    def steps(self, n: int) -> None:
        """Fused multi-token accounting: all ``n`` decode steps replay as
        one concatenated segment in a single batched engine pass
        (`decode_steps`; prefetch mode falls back to the per-token
        loop)."""
        self.executor.decode_steps(self.layer_paths, self.flops, n,
                                   materialize=False)

    def report(self, decoded: int) -> str:
        m = self.executor.metrics()
        return (
            f"svm stream: DOS {m['dos']:.0f}% "
            f"(pool {self.budget / 1e6:.1f}MB / "
            f"weights {self.total_bytes / 1e6:.1f}MB), "
            f"simulated decode wall {m['wall_s'] * 1e3:.2f}ms, "
            f"{m['migrations']} migs / {m['evictions']} evicts "
            f"(e2m {m['evict_to_mig']:.2f}), "
            f"session: {m['segment_cache_misses']} compiled / "
            f"{m['segment_cache_hits']} cached replays over "
            f"{decoded} tokens")


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
    ap.add_argument("--svm-budget-frac", type=float, default=0.0,
                    help="enable SVM weight-streaming accounting with a "
                         "device pool of this fraction of the param bytes")
    ap.add_argument("--svm-policy", default="lrf", choices=SVM_POLICIES)
    ap.add_argument("--svm-mode", default="naive", choices=SVM_MODES)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, seed=0, device=device)

    stream = None
    if args.svm_budget_frac > 0.0:
        stream = WeightStream(params, args.batch,
                              budget_frac=args.svm_budget_frac,
                              policy=args.svm_policy, mode=args.svm_mode,
                              device=device)

    toks = prompts(cfg, args.batch, args.prompt_len, device)
    with torch.inference_mode():
        tok, _, cache, t_pre = run_prefill(cfg, params, toks)
        decoded, cache, t_dec = run_decode(cfg, params, tok, cache,
                                           args.decode)
    # the streaming accounting is a pure function of the token count:
    # replay it outside the timed loop so tok/s stays the real number
    if stream is not None:
        stream.steps(args.decode)
    seq = torch.cat([tok] + decoded, dim=1)
    print(f"prefill {args.batch}x{args.prompt_len} in {t_pre:.1f}ms; "
          f"decoded {args.decode} tokens in {t_dec:.1f}ms "
          f"({args.batch * args.decode / max(t_dec / 1e3, 1e-9):.1f} tok/s) "
          f"on {device}")
    if stream is not None:
        print(stream.report(args.decode))
    print("first request continuation:", seq[0].tolist())


if __name__ == "__main__":
    main()
