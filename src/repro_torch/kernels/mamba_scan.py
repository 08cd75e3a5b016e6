"""Selective scan on the card: the Mamba-1 recurrence with an fp32 state,
returning y and the final state.

The kernel (``csrc/mamba_scan.cu``) replaces ``_scan_kernel`` /
``mamba_scan_pallas`` (``repro/kernels/mamba_scan.py:27,51``). It takes any
S and D and N <= 64, and it also returns ``h_last``, which the Pallas
kernel keeps in scratch: the model's prefill hands it to decode. A tensor
on the CPU takes the plain version (``ref.mamba_scan_ref``); a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0

MAX_N = 64   # the largest state width instantiated in csrc/mamba_scan.cu
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("mamba_scan").repro_mamba_scan
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def mamba_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N) -> (y (Bt,S,D) in x's
    dtype, h_last (Bt,D,N) fp32). dt, A, B and C are fp32; x is fp32 or
    bf16; all contiguous."""
    global launches
    ts = (dt, A, B, C, x)
    if all(t.device.type == "cpu" for t in ts):
        return ref.mamba_scan_ref(dt, A, B, C, x)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("mamba_scan: dt, A, B, C, x must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts[:4]) \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mamba_scan kernel takes fp32 dt, A, B, C and fp32 "
                         f"or bf16 x, got {[t.dtype for t in ts]}")
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2:
        raise ValueError(f"mamba_scan: bad shapes dt {tuple(dt.shape)}, "
                         f"x {tuple(x.shape)}, A {tuple(A.shape)}")
    Bt, S, D = x.shape
    N = A.shape[1]
    if A.shape[0] != D or B.shape != (Bt, S, N) or C.shape != (Bt, S, N):
        raise ValueError(f"mamba_scan: A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)} do not match x {tuple(x.shape)}")
    if not 1 <= N <= MAX_N or Bt > 65535:
        raise ValueError(f"mamba_scan kernel takes 1 <= N <= {MAX_N} and "
                         f"Bt <= 65535, got N={N}, Bt={Bt}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mamba_scan kernel takes contiguous operands")
    y = torch.empty((Bt, S, D), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bt, D, N), dtype=torch.float32, device=x.device)
    if Bt == 0 or D == 0:
        return y, h_last
    err = _kernel()(dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    x.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                    Bt, S, D, N, int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, h_last
