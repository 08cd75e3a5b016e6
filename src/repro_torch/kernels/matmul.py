"""Matmul on the card: C = A @ B with fp32 accumulation, in A's dtype.

The kernel (``csrc/matmul.cu``) replaces ``_matmul_kernel`` /
``matmul_pallas`` (``repro/kernels/matmul.py:24,40``). A tensor on the CPU
takes the plain version (``ref.matmul_ref``); a CUDA tensor launches the
kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0

_fn = None
_MAX_M = 65535 * 128  # grid.y limit times the tile height for M > 16


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("matmul").repro_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           b_transposed: bool = False) -> torch.Tensor:
    """A: (M, K); B: (K, N), or (N, K) row-major when ``b_transposed``
    (read in place, e.g. a tied embedding table as the LM head)."""
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul_ref(a, b, b_transposed)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"matmul: a and b must be on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise ValueError(f"matmul kernel takes bf16 or fp32 of one dtype, got "
                         f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul kernel takes 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous row-major operands")
    M, K = a.shape
    N, Kb = b.shape if b_transposed else b.shape[::-1]
    if K != Kb:
        raise ValueError(f"matmul: inner dims differ: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, b_transposed={b_transposed}")
    if M > _MAX_M or N >= 2 ** 31 - 128:
        raise ValueError(f"matmul kernel: shape ({M}, {K}) x ({K}, {N}) "
                         f"exceeds its launch grid")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                    int(b_transposed), int(a.dtype == torch.bfloat16),
                    torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {err}")
    launches += 1
    return out
