"""Flash-attention forward on the card, bf16, with GQA and a sliding window.

The kernel (``csrc/flash_attention.cu``) replaces ``_flash_kernel`` /
``flash_attention_pallas`` (``repro/kernels/flash_attention.py:23,71``).
With KV == H, ``window=0`` and the default scale it computes what the
Pallas kernel computes, including its top-left causal rule. A tensor on the
CPU takes the plain version (``ref.flash_attention_ref``); a CUDA tensor
launches the kernel or raises. ``route`` picks one of the kernel's two
routes from the head dim and the dtype before the launch; ``launches``
counts kernel launches and ``route_launches`` counts them by route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# the C side's route numbers are the indices
ROUTES = ("mma_sync", "wgmma")
HEAD_DIMS = (16, 32, 64, 128, 256)  # the instantiations in csrc/flash_attention.cu
# rows of 128 bytes or more: whole atoms of the 128-byte swizzle that TMA
# writes and wgmma reads
WGMMA_HEAD_DIMS = (64, 128, 256)
# the wgmma route's plan (csrc/flash_attention.cu, namespace wg): a block's
# query rows, the keys of a ring stage, and the shared memory a block may
# use on an H100 (227 KB)
WGMMA_BQ, WGMMA_BKV = 128, 64
SMEM_LIMIT = 232448

launches = 0
route_launches = dict.fromkeys(ROUTES, 0)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").repro_flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def route(D: int, dtype: torch.dtype) -> str:
    """The kernel route for head dim ``D``: wgmma (TMA-fed, warp
    specialised) where a row fills the 128-byte swizzle, else mma_sync.
    The wrapper's checks (16-byte aligned rows, unit stride along D) are
    what TMA needs, so nothing else enters."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma_sync"


def wgmma_stages(D: int) -> int:
    """Ring stages of K and V tiles on the wgmma route."""
    return 2 if D == 256 else 4


def wgmma_smem_bytes(D: int) -> int:
    """Shared memory of a wgmma-route block: Q (128 rows), the K and V
    rings, 1024 bytes to align the swizzle atoms, and the mbarriers."""
    stages = wgmma_stages(D)
    return (WGMMA_BQ * D * 2 + 2 * stages * WGMMA_BKV * D * 2 + 1024
            + 8 * (1 + 4 * stages))


def _check_operand(name: str, x: torch.Tensor) -> None:
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be contiguous along D")
    if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
        raise ValueError(f"flash_attention: {name} needs 16-byte aligned rows")


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int) -> tuple[int, int, int, int, int, int]:
    """Raises ValueError unless the kernel takes q, k and v; returns (B, H,
    KV, S, T, D)."""
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
    return B, H, KV, S, T, D


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
    B, H, KV, S, T, D = check_operands(q, k, v, window)
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    if T == 0:
        return out.zero_()
    scale = D ** -0.5 if scale is None else float(scale)
    which = route(D, q.dtype)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, KV, S, T, D, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], int(causal), int(window), scale,
                    ROUTES.index(which),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel ({which} route) launch "
                           f"failed: error {err}")
    launches += 1
    route_launches[which] += 1
    return out
