"""Dispatch between the port's CUDA kernels and their plain versions.

``impl="auto"`` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; ``"cuda"`` insists on the kernel (a CPU tensor
raises); ``"torch"`` takes the plain version on any device, which is how
the kernels are held against it on the card. Counterpart of
``repro/kernels/ops.py``, whose ``auto|pallas|jnp`` these mirror.

Where an operand needs a gradient, ``matmul``, ``flash_attention`` and
``mamba_scan`` run as ``torch.autograd.Function``s whose backward passes
take the same ``impl``: the matmul's two gradient products are this
``matmul`` again (the hand-written kernel on the card), flash attention's
is ``flash_attention_bwd`` and the selective scan's ``mamba_scan_bwd``
(their backward kernels on the card).
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
    """Whether ``impl`` sends an operand like ``x`` to a CUDA kernel. A
    DTensor raises: the kernels take a rank's local tensors only."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|cuda|torch, got {impl!r}")
    if type(x) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            raise TypeError("a DTensor reached a kernel's dispatch; pass its "
                            "local tensor (to_local())")
    if impl == "torch":
        return False
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return x.is_cuda


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _mm(a2: torch.Tensor, b: torch.Tensor, b_transposed: bool,
        impl: str) -> torch.Tensor:
    if uses_kernel(a2, impl):
        return _matmul.matmul(a2, b, b_transposed=b_transposed)
    return ref.matmul_ref(a2, b, b_transposed)


def _t(x: torch.Tensor) -> torch.Tensor:
    """x^T, row-major: the kernel reads only row-major operands, and its
    wgmma route only a (K, N) B."""
    return x.t().contiguous()


class _Matmul(torch.autograd.Function):
    """C = A B (or A B^T) on (M, K) A. Backward: dA = dC B^T and dB = A^T dC
    (dB = dC^T A for a transposed B), each one more ``_mm`` of the same
    impl, with the transposed operand made row-major."""

    @staticmethod
    def forward(ctx, a2, b, b_transposed, impl):
        ctx.save_for_backward(a2, b)
        ctx.b_transposed, ctx.impl = b_transposed, impl
        return _mm(a2, b, b_transposed, impl)

    @staticmethod
    def backward(ctx, dc):
        a2, b = ctx.saved_tensors
        bt, impl = ctx.b_transposed, ctx.impl
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm(dc, b if bt else _t(b), False, impl)
        if ctx.needs_input_grad[1]:
            db = _mm(_t(dc), a2, False, impl) if bt else \
                _mm(_t(a2), dc, False, impl)
        return da, db, None, None


def matmul(a: torch.Tensor, b: torch.Tensor, *, b_transposed: bool = False,
           impl: str = "auto") -> torch.Tensor:
    """``a @ b`` (or ``a @ b.T`` with ``b_transposed``) over the last dim of
    ``a``; leading dims of ``a`` are flattened into M."""
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    if _needs_grad(a2, b):
        out = _Matmul.apply(a2, b, b_transposed, impl)
    else:
        out = _mm(a2, b, b_transposed, impl)
    return out.reshape(*a.shape[:-1], out.shape[-1])


class _FlashAttention(torch.autograd.Function):
    """Forward with the row log-sum-exp, saving q, k, v, o and lse;
    backward by ``flash_attention_bwd`` (the kernel on the card, the plain
    version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _flash.flash_attention(q, k, v, causal, window, scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    scale: float | None = None, impl: str = "auto"):
    """q: (B,H,S,D); k, v: (B,KV,T,D) -> (B,H,S,D)."""
    if uses_kernel(q, impl):
        if _needs_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, window, scale)
        return _flash.flash_attention(q, k, v, causal, window, scale)
    return ref.flash_attention_ref(q, k, v, causal, window, scale)


class _MambaScan(torch.autograd.Function):
    """The selective scan. Forward: on the card the scan kernel's training
    instance, which also saves the state at every chunk start; on the CPU
    the plain version. Backward: ``mamba_scan_bwd`` from those states (the
    kernel on the card, ``mamba_scan_bwd_ref`` on the CPU); h_last's
    gradient is zeros where h_last is unused."""

    @staticmethod
    def forward(ctx, dt, A, B, C, x):
        if x.is_cuda:
            y, h_last, hc = _scan.mamba_scan(dt, A, B, C, x, chunk_states=True)
        else:
            (y, h_last), hc = _scan.mamba_scan(dt, A, B, C, x), None
        ctx.save_for_backward(dt, A, B, C, x, hc)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, A, B, C, x, hc = ctx.saved_tensors
        grads = _scan.mamba_scan_bwd(dt, A, B, C, x, dy.contiguous(),
                                     dh_last.contiguous(), hc)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def mamba_scan(dt, A, B, C, x, impl: str = "auto"):
    """Selective scan. dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N) -> (y
    (Bt,S,D) in x's dtype, final state h_last (Bt,D,N) fp32)."""
    if uses_kernel(x, impl):
        if _needs_grad(dt, A, B, C, x):
            return _MambaScan.apply(dt, A, B, C, x)
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
