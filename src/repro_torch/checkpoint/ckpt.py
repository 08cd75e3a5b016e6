"""Checkpointing: tree save/restore with atomic step directories, async
writes, and retention — the port of ``repro/checkpoint/ckpt.py``, in its
on-disk layout, so that checkpoints cross between the packages both ways:
``root/step_<step:08d>/`` holds ``shard<id>.npz`` (leaf ``i`` of the tree
in ``bridge.leaves`` order, JAX's, under the name ``"i"``) and
``manifest.msgpack`` (``{"step", "leaves": {path: {"idx", "shape",
"dtype"}}, "shard"}``). bf16 leaves are stored as their uint16 bits with
the logical dtype ``"bfloat16"``. A step is committed by an atomic rename
of its ``.tmp<shard>`` directory, so a crash mid-write never corrupts the
latest checkpoint. Trees are nested dicts of torch tensors; the manifest
goes through the port's own msgpack codec (``_msgpack``), and bf16 bits
through torch views, so neither ``msgpack`` nor ``ml_dtypes`` is needed.
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.bridge import leaves, tree_map, unflatten
from repro_torch.checkpoint import _msgpack

_MANIFEST = "manifest.msgpack"


def _to_storable(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A CPU tensor as the array stored and its logical dtype's name."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.numpy()
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")   # keeps a 0-dim leaf 0-dim
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if name.startswith("float8"):
        raise ValueError(f"checkpoint leaf of dtype {name}: the port has no "
                         f"float8 leaves")
    return torch.from_numpy(arr)


def save(root: str, step: int, tree: dict, *, shard_id: int = 0) -> str:
    """Write ``tree`` under root/step_<step>; atomic via tmp+rename."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + f".tmp{shard_id}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    stored = {}
    for i, (path, x) in enumerate(leaves(tree)):
        sv, logical = _to_storable(x.detach().cpu().contiguous())
        stored[str(i)] = sv
        manifest[path] = {"idx": i, "shape": list(x.shape), "dtype": logical}
    with open(os.path.join(tmp, f"shard{shard_id}.npz"), "wb") as f:
        np.savez(f, **stored)
    with open(os.path.join(tmp, _MANIFEST), "wb") as f:
        f.write(_msgpack.packb({"step": step, "leaves": manifest,
                                "shard": shard_id}))
    if not os.path.exists(final):
        os.replace(tmp, final)
    else:
        _merge(tmp, final)
    return final


def _merge(tmp: str, final: str) -> None:
    for name in os.listdir(tmp):
        os.replace(os.path.join(tmp, name), os.path.join(final, name))
    shutil.rmtree(tmp, ignore_errors=True)


def restore(root: str, step: int, like: dict, *, shard_id: int = 0) -> dict:
    """Restore into the structure of ``like`` (shapes checked), each leaf
    cast to the dtype of ``like``'s and placed on its device."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST), "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    out = {}
    with np.load(os.path.join(d, f"shard{shard_id}.npz")) as data:
        for path, ref in leaves(like):
            meta = manifest["leaves"][path]
            x = _from_storable(data[str(meta["idx"])], meta["dtype"])
            if list(x.shape) != list(ref.shape):
                raise ValueError(f"checkpoint mismatch at {path}: "
                                 f"{tuple(x.shape)} vs {tuple(ref.shape)}")
            out[path] = x.to(device=ref.device, dtype=ref.dtype)
    return unflatten(out)


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(root)
             if n.startswith("step_") and not n.endswith(".tmp0")
             and "." not in n.split("_")[1]]
    return max(steps) if steps else None


class CheckpointManager:
    """Async, retained checkpointing for the train loop."""

    def __init__(self, root: str, *, keep: int = 3, every: int = 100):
        self.root = root
        self.keep = keep
        self.every = every
        self._thread: threading.Thread | None = None

    def maybe_save(self, step: int, tree: dict, *, blocking: bool = False
                   ) -> bool:
        if step % self.every != 0:
            return False
        self.wait()
        # snapshot to host memory before returning control to the step loop
        snap = tree_map(lambda x: x.detach().to("cpu", copy=True), tree)

        def work():
            save(self.root, step, snap)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(s for s in (
            int(n.split("_")[1]) for n in os.listdir(self.root)
            if n.startswith("step_") and "." not in n.split("_", 1)[1]))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: dict) -> tuple[int, dict] | None:
        self.wait()
        step = latest_step(self.root)
        if step is None:
            return None
        return step, restore(self.root, step, like)
