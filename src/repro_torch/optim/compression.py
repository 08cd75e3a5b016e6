"""Gradient compression for cross-pod data parallelism — port of
``repro.optim.compression``.

At 1000+ node scale the gradient all-reduce over the ``pod`` axis crosses
links an order of magnitude slower than those inside a pod. Int8
block-quantised gradients with error feedback keep convergence (the
feedback buffer re-injects quantisation residuals next step, bounding
bias — Seide et al. / Karimireddy et al.), but ``compressed_psum`` does
not cut the wire's bytes: it sums the requantised integers in int32, so
its two all-reduces move 4 bytes an element plus 4 bytes of scale a
256-block, 1/256 more than the fp32 all-reduce (202 125 360 against
201 338 880 bytes at (49 155, 1 024)); the int8 q never crosses. The
reference's does the same: the 4x cut its docstring claims would need
the int8 payload itself on the wire.

Two entry points:
  * ``compress``/``decompress`` + ``quantize_with_error_feedback`` — the
    numerics, on any tensor;
  * ``compressed_psum`` — an all-reduce over a process group that sums
    block-quantised integers against one shared scale per block.

The rounding is the reference's: ``torch.round`` rounds half to even, as
``jnp.round`` does, so q and the scales equal the reference's bit for bit.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

PyTree = Any

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    return F.pad(flat, (0, pad)), pad


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-256-block symmetric int8 quantisation. Returns (q, scales)."""
    flat, _ = _pad_to_block(g.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-20)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress(q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def quantize_with_error_feedback(grads: PyTree, err: PyTree
                                 ) -> tuple[PyTree, PyTree]:
    """g' = Q(g + err);  err' = (g + err) - g'. Applied leaf-wise over
    nested dicts (or one tensor)."""
    if isinstance(grads, dict):
        pairs = {k: quantize_with_error_feedback(grads[k], err[k])
                 for k in grads}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    corrected = grads.float() + err
    q, s = compress(corrected)
    deq = decompress(q, s, tuple(grads.shape), torch.float32)
    return deq.to(grads.dtype), corrected - deq


def init_error_feedback(params: PyTree) -> PyTree:
    """fp32 zeros shaped like each leaf of ``params``."""
    if isinstance(params, dict):
        return {k: init_error_feedback(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce over ``group`` (the default group when None) with an
    int8-quantised contribution from each rank: one shared scale per
    block, the max over the ranks; each rank's q requantised against it;
    the integer sum in int32."""
    import torch.distributed as dist

    q, scale = compress(x)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    # requantise against the shared scale so the integer sum is coherent
    total = torch.clamp(torch.round(q.float() * (scale / scale_max)[:, None]),
                        -127, 127).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    flat = (total.float() * scale_max[:, None]).reshape(-1)
    return flat[:x.numel()].reshape(x.shape).to(x.dtype)
