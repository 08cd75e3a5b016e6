"""Quickstart: build a small LM from the port's public API, train a few
steps on synthetic data, and decode — on the card, or with ``--device cpu``
on the CPU (the plain PyTorch path).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.bridge import tree_map
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import init_params, prefill
from repro_torch.optim import OptConfig, make_optimizer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = dataclasses.replace(get_reduced("granite-3-2b"), n_layers=4)
    print(f"model: {cfg.name} reduced ({cfg.param_count()/1e6:.2f}M params)")

    # drawn on the host, so that the card and the CPU start from one set
    # of bits
    params = tree_map(lambda x: x.to(dev),
                      init_params(cfg, seed=0, device="cpu"))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    opt_init, _ = make_optimizer(opt_cfg)
    opt_state = opt_init(params)
    train_step = make_train_step(cfg, opt_cfg)

    data = SyntheticLM(vocab=cfg.vocab, seed=0)
    t0 = time.time()
    for step in range(30):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step, 0, 8, 64).items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % 10 == 0 or step == 29:
            print(f"step {step:3d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
    print(f"trained 30 steps in {time.time()-t0:.1f}s")

    # greedy decode a few tokens from a prompt
    prompt = torch.from_numpy(data.batch(999, 0, 1, 8)["tokens"]).to(dev)
    with torch.inference_mode():
        logits, cache = prefill(params, cfg, prompt, cache_len=32)
        serve = make_serve_step(cfg)
        tok = logits[:, -1:].argmax(dim=-1).int()
        out = [int(tok[0, 0])]
        for _ in range(8):
            tok, cache = serve(params, tok, cache)
            out.append(int(tok[0, 0]))
    print("decoded continuation ids:", out)


if __name__ == "__main__":
    main()
