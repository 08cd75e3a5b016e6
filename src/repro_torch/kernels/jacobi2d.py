"""One 5-point Jacobi-2d sweep on the card, fp32 or bf16.

The kernel (``csrc/jacobi2d.cu``) replaces ``_jacobi_kernel`` /
``jacobi2d_pallas`` (``repro/kernels/jacobi2d.py:20,42``) and sums as it
does (``ref.jacobi2d_ref`` states how); it takes any R and C. A tensor
on the CPU takes the plain version (``ref.jacobi2d_ref``); a CUDA tensor
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
        fn = build.load("jacobi2d").repro_jacobi2d
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def jacobi2d(a: torch.Tensor) -> torch.Tensor:
    """a: (R, C), fp32 or bf16, contiguous -> one sweep, a's dtype."""
    global launches
    if a.device.type == "cpu":
        return ref.jacobi2d_ref(a)
    if not a.is_cuda:
        raise ValueError(f"jacobi2d: a must be on a CUDA device, got {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"jacobi2d kernel takes fp32 or bf16, got {a.dtype}")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"jacobi2d kernel takes a contiguous 2-D grid, got "
                         f"shape {tuple(a.shape)}")
    R, C = a.shape
    out = torch.empty((R, C), dtype=a.dtype, device=a.device)
    if R == 0 or C == 0:
        return out
    err = _kernel()(a.data_ptr(), out.data_ptr(), R, C,
                    int(a.dtype == torch.bfloat16),
                    torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"jacobi2d kernel launch failed: cudaError {err}")
    launches += 1
    return out
