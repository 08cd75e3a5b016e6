"""Dispatch between the port's CUDA kernels and their plain versions.

``impl="auto"`` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; ``"cuda"`` insists on the kernel (a CPU tensor
raises); ``"torch"`` takes the plain version on any device, which is how
the kernels are held against it on the card. Counterpart of
``repro/kernels/ops.py``, whose ``auto|pallas|jnp`` these mirror.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import jacobi2d as _jacobi
from repro_torch.kernels import mamba_scan as _scan
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import ref
from repro_torch.kernels import stream_triad as _triad

IMPLS = ("auto", "cuda", "torch")


def uses_kernel(x: torch.Tensor, impl: str) -> bool:
    """Whether ``impl`` sends an operand like ``x`` to a CUDA kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|cuda|torch, got {impl!r}")
    if impl == "torch":
        return False
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return x.is_cuda


def matmul(a: torch.Tensor, b: torch.Tensor, *, b_transposed: bool = False,
           impl: str = "auto") -> torch.Tensor:
    """``a @ b`` (or ``a @ b.T`` with ``b_transposed``) over the last dim of
    ``a``; leading dims of ``a`` are flattened into M."""
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    if uses_kernel(a, impl):
        out = _matmul.matmul(a2, b, b_transposed=b_transposed)
    else:
        out = ref.matmul_ref(a2, b, b_transposed)
    return out.reshape(*a.shape[:-1], out.shape[-1])


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    scale: float | None = None, impl: str = "auto"):
    """q: (B,H,S,D); k, v: (B,KV,T,D) -> (B,H,S,D)."""
    if uses_kernel(q, impl):
        return _flash.flash_attention(q, k, v, causal, window, scale)
    return ref.flash_attention_ref(q, k, v, causal, window, scale)


def mamba_scan(dt, A, B, C, x, impl: str = "auto"):
    """Selective scan. dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N) -> (y
    (Bt,S,D) in x's dtype, final state h_last (Bt,D,N) fp32)."""
    if uses_kernel(x, impl):
        return _scan.mamba_scan(dt, A, B, C, x)
    return ref.mamba_scan_ref(dt, A, B, C, x)


def triad(b: torch.Tensor, c: torch.Tensor, alpha: float,
          impl: str = "auto") -> torch.Tensor:
    """STREAM triad b + alpha * c (the paper's Category-I kernel)."""
    if uses_kernel(b, impl):
        return _triad.triad(b, c, alpha)
    return ref.triad_ref(b, c, alpha)


def jacobi2d(a: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """One 5-point Jacobi sweep over a (R, C) grid (the paper's
    Category-II kernel); boundary rows and columns pass through."""
    if uses_kernel(a, impl):
        return _jacobi.jacobi2d(a)
    return ref.jacobi2d_ref(a)
