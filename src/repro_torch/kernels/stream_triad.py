"""STREAM triad on the card: a = b + alpha * c, fp32 or bf16.

The kernel (``csrc/triad.cu``) replaces ``_triad_kernel`` /
``triad_pallas`` (``repro/kernels/stream_triad.py:21,27``) and rounds as
it does (``ref.triad_ref`` states how). It takes any shape. A tensor on
the CPU takes the plain version (``ref.triad_ref``); a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("triad").repro_triad
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_int64,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def triad(b: torch.Tensor, c: torch.Tensor, alpha: float) -> torch.Tensor:
    """b, c: one shape, fp32 or bf16 of one dtype, contiguous."""
    global launches
    if b.device.type == "cpu" and c.device.type == "cpu":
        return ref.triad_ref(b, c, alpha)
    if not (b.is_cuda and c.is_cuda and b.device == c.device):
        raise ValueError(f"triad: b and c must be on one CUDA device, got "
                         f"{b.device} and {c.device}")
    if b.dtype not in (torch.float32, torch.bfloat16) or c.dtype != b.dtype:
        raise ValueError(f"triad kernel takes fp32 or bf16 of one dtype, got "
                         f"{b.dtype} and {c.dtype}")
    if b.shape != c.shape:
        raise ValueError(f"triad: shapes differ: {tuple(b.shape)} and "
                         f"{tuple(c.shape)}")
    if not (b.is_contiguous() and c.is_contiguous()):
        raise ValueError("triad kernel takes contiguous operands")
    a = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if b.numel() == 0:
        return a
    err = _kernel()(b.data_ptr(), c.data_ptr(), a.data_ptr(),
                    ref.triad_alpha(alpha, b.dtype), b.numel(),
                    int(b.dtype == torch.bfloat16),
                    torch.cuda.current_stream(b.device).cuda_stream)
    if err:
        raise RuntimeError(f"triad kernel launch failed: cudaError {err}")
    launches += 1
    return a
