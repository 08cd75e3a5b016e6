"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
with SVM-managed activation offload, comparing the naive forward-order
replay schedule against the SVM-aware reverse schedule (the paper's
Jacobi2d insight mapped to training) — the port's copy of
``examples/train_oversubscribed.py``: the training runs on the card
(``--device cpu``: on the CPU), the offload schedule on the simulated
clock with the H100 preset's rates.

    PYTHONPATH=src python examples/torch/train_oversubscribed.py [--steps N]

As in the reference, a run longer than the warmup (20 steps) must end
with a lower loss than it began with; a shorter one checks only that every
loss is finite.
"""

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch.bridge import tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.ft import TrainSupervisor
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.svm import plan_offload, simulate_offload


def build_100m():
    """~100M-parameter dense config (granite family, shrunk)."""
    base = get_reduced("granite-3-2b")
    return dataclasses.replace(
        base, name="granite-100m", vocab=32768, d_model=512, n_layers=8,
        d_ff=2048, n_heads=8, n_kv_heads=4)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_100m()
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params), "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq}")

    # --- SVM activation-offload plan for this model under a tight budget
    act_bytes = args.batch * args.seq * cfg.d_model * 2
    budget = 3 * act_bytes  # device pool holds 3 of 8 layer activations
    naive = simulate_offload(plan_offload(cfg.n_layers, act_bytes, budget,
                                          svm_aware=False))
    aware = simulate_offload(plan_offload(cfg.n_layers, act_bytes, budget,
                                          svm_aware=True))
    print(f"offload schedule (DOS={cfg.n_layers*act_bytes/budget*100:.0f}%):"
          f" naive replay {naive['migrations']} migs/{naive['wall_s']*1e3:.2f}ms"
          f" vs svm-aware {aware['migrations']} migs/"
          f"{aware['wall_s']*1e3:.2f}ms "
          f"({naive['wall_s']/aware['wall_s']:.2f}x)")

    # --- real training under the fault-tolerant supervisor
    # drawn on the host, so that the card and the CPU start from one set
    # of bits
    params = tree_map(lambda x: x.to(dev),
                      init_params(cfg, seed=0, device="cpu"))
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    opt_init, _ = make_optimizer(opt_cfg)
    state = {"params": params, "opt": opt_init(params)}
    train_step = make_train_step(cfg, opt_cfg, microbatches=2)
    data = SyntheticLM(vocab=cfg.vocab, seed=0)
    losses = []

    def step_fn(step, st):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step, 0, args.batch, args.seq).items()}
        p, o, m = train_step(st["params"], st["opt"], batch)
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"  step {step:4d} loss={losses[-1]:.4f}")
        return {"params": p, "opt": o}

    sup = TrainSupervisor(CheckpointManager(args.ckpt, keep=2, every=50))
    t0 = time.time()
    final_step, state = sup.run(state, step_fn, steps=args.steps)
    dt = time.time() - t0
    print(f"finished {final_step} steps in {dt:.1f}s "
          f"({args.steps*args.batch*args.seq/dt:.0f} tok/s); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    # a run past the warmup must lower the loss; a shorter one (a smoke
    # run of a few steps at a near-zero learning rate) sees only the
    # batches' spread
    if args.steps > opt_cfg.warmup_steps:
        assert losses[-1] < losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
