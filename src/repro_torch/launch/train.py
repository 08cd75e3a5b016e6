"""Training launcher of the port — port of ``repro.launch.train``.

It runs on CUDA unless given ``--device cpu``: every projection and the
chunked LM head through the matmul kernel, whole-sequence attention
through the flash kernel, Mamba layers through the scan kernel, and their
backward passes through the same matmul kernel, the flash backward kernel
and the scan's backward kernel. Fault tolerance
(checkpoint/restart and straggler monitoring) is always on via the
supervisor, with checkpoints under ``--ckpt``; a second run with the same
``--ckpt`` resumes from the latest one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --steps 50 --batch 8 --seq 64

``--production-mesh`` asks for the (16, 16) production mesh
(``launch/mesh.py``), which needs 256 ranks and raises in a world of
another size, as the reference's does on one device; without it the run
takes the 1 x 1 host mesh. As in the reference, the mesh leaves the
computation on this process's device.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import tempfile
import time

import torch

from repro_torch.bridge import init_params, leaves
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.ft import TrainSupervisor
from repro_torch.launch.mesh import (axis_sizes, close_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.serve import context
from repro_torch.launch.settings import settings_for
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import OptConfig, make_optimizer


def state_digest(state: dict) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes in tree
    order: two states with the same digest are equal bit for bit."""
    h = hashlib.sha256()
    for path, x in leaves(state):
        # a dense copy: a fresh optimizer state's zeros are broadcast
        x = x.detach().cpu().clone(memory_format=torch.contiguous_format)
        h.update(f"{path} {x.dtype} {tuple(x.shape)}".encode())
        h.update(x.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"),
                    help="checkpoint directory (default: under $TMPDIR)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    st = settings_for(args.arch)
    mesh = (make_production_mesh(device=dev) if args.production_mesh
            else make_host_mesh(dev))
    try:
        _train(args, cfg, st, dev, axis_sizes(mesh))
    finally:
        close_mesh(mesh)


def _train(args, cfg, st, dev: torch.device, mesh_shape: dict) -> None:
    """``main``'s run, inside its mesh."""
    mb = 1 if args.reduced else st.microbatches
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"mesh={mesh_shape} device={dev} microbatches={mb}")

    params = init_params(cfg, seed=0, device=dev)
    opt_cfg = OptConfig(kind=st.optimizer, lr=args.lr,
                        warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps)
    opt_init, _ = make_optimizer(opt_cfg)
    state = {"params": params, "opt": opt_init(params)}
    step_fn_ = make_train_step(cfg, opt_cfg, microbatches=mb)

    data = SyntheticLM(vocab=cfg.vocab, seed=0)
    host = 0
    ctx = context(cfg, args.batch, dev)   # modality_stub, as the reference

    def step_fn(step, st_):
        b = data.batch(step, host, args.batch, args.seq)
        batch = {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                 "labels": torch.from_numpy(b["labels"]).to(dev)}
        if ctx is not None:
            batch["ctx"] = ctx
        p, o, m = step_fn_(st_["params"], st_["opt"], batch)
        if step % 10 == 0:
            print(f"  step {step:4d} loss={float(m['loss']):.4f}")
        return {"params": p, "opt": o}

    sup = TrainSupervisor(CheckpointManager(args.ckpt, keep=2,
                                            every=max(args.steps // 4, 1)))
    t0 = time.time()
    final, state = sup.run(state, step_fn, steps=args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    for line in sup.log:
        print(line)
    print(f"done: {final} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    print(f"state sha256 {state_digest(state)}")


if __name__ == "__main__":
    main()
