"""Flash-attention forward on the card, bf16, with GQA and a sliding window.

The kernel (``csrc/flash_attention.cu``) replaces ``_flash_kernel`` /
``flash_attention_pallas`` (``repro/kernels/flash_attention.py:23,71``).
With KV == H, ``window=0`` and the default scale it computes what the
Pallas kernel computes, including its top-left causal rule. A tensor on the
CPU takes the plain version (``ref.flash_attention_ref``); a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)  # the instantiations in csrc/flash_attention.cu
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").repro_flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_operand(name: str, x: torch.Tensor) -> None:
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be contiguous along D")
    if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
        raise ValueError(f"flash_attention: {name} needs 16-byte aligned rows")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B,H,S,D); k, v: (B,KV,T,D), H % KV == 0 -> (B,H,S,D) contiguous.
    q, k and v may be strided views (e.g. a (B,S,H,D) tensor transposed),
    as long as D is the unit-stride dim. ``scale`` defaults to D^-0.5."""
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, window, scale)
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if not all(x.dtype == torch.bfloat16 for x in (q, k, v)):
        raise ValueError(f"flash_attention kernel takes bf16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, D = q.shape
    Bk, KV, T, Dk = k.shape
    if Bk != B or Dk != D or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, got {D}")
    if B * H > 65535 or window < 0:
        raise ValueError(f"flash_attention: B*H={B * H} > 65535 or window < 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x)
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    if T == 0:
        return out.zero_()
    scale = D ** -0.5 if scale is None else float(scale)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, KV, S, T, D, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], int(causal), int(window), scale,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
