"""Flash attention on the card, bf16, with GQA and a sliding window: the
forward pass, and the backward pass that training runs.

The kernel (``csrc/flash_attention.cu``) replaces ``_flash_kernel`` /
``flash_attention_pallas`` (``repro/kernels/flash_attention.py:23,71``).
With KV == H, ``window=0`` and the default scale it computes what the
Pallas kernel computes, including its top-left causal rule. A tensor on the
CPU takes the plain version (``ref.flash_attention_ref``); a CUDA tensor
launches the kernel or raises. ``route`` picks one of the kernel's two
routes from the head dim and the dtype before the launch; ``launches``
counts kernel launches and ``route_launches`` counts them by route. With
``return_lse`` the forward also writes the row log-sum-exp, from which
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``, its route picked
by ``bwd_route``, counted by ``bwd_launches`` and ``bwd_route_launches``)
computes dq, dk and dv.
"""

from __future__ import annotations

import ctypes
import math

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
# the backward kernel (csrc/flash_attention_bwd.cu), the C side's route
# numbers are the indices; a call's launches (Delta, then dK/dV and dQ:
# one launch on wgmma, two on mma_sync) count once
BWD_ROUTES = ("wgmma", "mma_sync")
bwd_launches = 0
bwd_route_launches = dict.fromkeys(BWD_ROUTES, 0)

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").repro_flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("flash_attention_bwd").repro_flash_attention_bwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


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


def bwd_route(D: int, dtype: torch.dtype) -> str:
    """The backward kernel's route for head dim ``D``: wgmma (TMA-fed
    rings, every product a wgmma) where a row fills the 128-byte swizzle,
    else mma_sync; the forward's rule (``route``)."""
    return route(D, dtype)


def bwd_wgmma_plan(D: int) -> dict:
    """The backward wgmma route's tiles (csrc/flash_attention_bwd.cu,
    namespace wg): the keys of a dK/dV block (at D = 256 its two consumer
    warpgroups share 64 keys and split the columns) and its ring stages
    of 64-row Q and dO tiles; the keys of a dQ ring stage (K and V tiles)
    and its stages, for 128 query rows a block."""
    return dict(dkv_keys=64 if D == 256 else 128,
                dkv_stages=2 if D == 256 else 4,
                dq_keys=32 if D == 256 else 64,
                dq_stages=2 if D == 256 else 4)


def bwd_wgmma_smem_bytes(D: int) -> dict:
    """Shared memory of a wgmma-route backward block: its dK/dV role holds
    K and V, the ring of Q and dO tiles and of their lse and Delta rows;
    its dQ role Q and dO (128 rows) and the ring of K and V tiles; each
    1024 bytes to align the swizzle atoms. A block has the larger of the
    two and both roles' mbarriers."""
    p = bwd_wgmma_plan(D)
    dkv = (2 * p["dkv_keys"] * D * 2
           + p["dkv_stages"] * (2 * 64 * D * 2 + 2 * 64 * 4) + 1024)
    dq = (2 * WGMMA_BQ * D * 2 + p["dq_stages"] * 2 * p["dq_keys"] * D * 2
          + 1024)
    bars = 8 * (2 + 2 * p["dkv_stages"] + 2 * p["dq_stages"])
    return dict(dkv=dkv, dq=dq, block=max(dkv, dq) + bars)


def bwd_scratch_floats(B: int, H: int, S: int, which: str) -> int:
    """fp32 scratch of a backward call: Delta (B, H, S) on mma_sync; on
    wgmma Delta and lse * log2(e), each with rows padded to 64 a head
    for the bulk copies of whole 64-row tiles."""
    if which == "wgmma":
        return 2 * B * H * (-(-S // 64) * 64)
    return B * H * S


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
                    scale: float | None = None, return_lse: bool = False):
    """q: (B,H,S,D); k, v: (B,KV,T,D), H % KV == 0 -> (B,H,S,D) contiguous.
    q, k and v may be strided views (e.g. a (B,S,H,D) tensor transposed),
    as long as D is the unit-stride dim. ``scale`` defaults to D^-0.5.
    With ``return_lse`` also the fp32 row log-sum-exp (B,H,S) of the scaled
    scores, which the backward pass (``flash_attention_bwd``) reads."""
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, window, scale,
                                       return_lse)
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    B, H, KV, S, T, D = check_operands(q, k, v, window)
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if S == 0 or T == 0:
        if T == 0:
            out.zero_()
            if lse is not None:
                lse.fill_(-math.inf)
        return (out, lse) if return_lse else out
    scale = D ** -0.5 if scale is None else float(scale)
    which = route(D, q.dtype)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, KV, S, T, D, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], int(causal), int(window), scale,
                    ROUTES.index(which),
                    None if lse is None else lse.data_ptr(),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel ({which} route) launch "
                           f"failed: error {err}")
    launches += 1
    route_launches[which] += 1
    return (out, lse) if return_lse else out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if the kernel can read it in place (unit stride along
    D, 16-byte aligned rows), else a contiguous copy: autograd may hand
    the backward pass a gradient of any layout."""
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and \
            not any(s % 8 for s in x.stride()[:3]):
        return x
    return x.contiguous()


def check_bwd_operands(q, k, v, o, lse, do, window: int
                       ) -> tuple[int, int, int, int, int, int]:
    """Raises ValueError unless the backward kernel takes the operands on
    the route ``bwd_route`` picks (q, k and v as the forward takes them;
    o and do like q; lse fp32 (B, H, S)); returns (B, H, KV, S, T, D)."""
    B, H, KV, S, T, D = check_operands(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} "
                         f"and do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be fp32 {(B, H, S)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    return B, H, KV, S, T, D


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """The backward pass of ``flash_attention`` -> (dq, dk, dv): q, o, do
    (B,H,S,D), k, v (B,KV,T,D) as the forward took them, ``lse`` the
    forward's (B,H,S) fp32 row log-sum-exp. Gradients come out
    contiguous in bf16, dk and dv summed over each KV head's q heads. A
    tensor on the CPU takes ``ref.flash_attention_bwd_ref``; a CUDA tensor
    launches the kernel (csrc/flash_attention_bwd.cu) on ``bwd_route``'s
    route or raises. Each block of the kernel owns the rows it writes:
    two calls give the same bits."""
    global bwd_launches
    ts = (q, k, v, o, lse, do)
    if all(x.device.type == "cpu" for x in ts):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                           window, scale)
    if not all(x.is_cuda and x.device == q.device for x in ts):
        raise ValueError("flash_attention_bwd: every operand must be on one "
                         "CUDA device")
    B, H, KV, S, T, D = check_bwd_operands(q, k, v, o, lse, do, window)
    o, do, lse = _aligned(o), _aligned(do), lse.contiguous()
    dq = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KV, T, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, KV, T, D), dtype=v.dtype, device=q.device)
    if S == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    which = bwd_route(D, q.dtype)
    scratch = torch.empty(bwd_scratch_floats(B, H, S, which),
                          dtype=torch.float32, device=q.device)
    scale = D ** -0.5 if scale is None else float(scale)
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, KV, S, T, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], *do.stride()[:3], int(causal),
        int(window), scale, BWD_ROUTES.index(which),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel ({which} route) "
                           f"launch failed: error {err}")
    bwd_launches += 1
    bwd_route_launches[which] += 1
    return dq, dk, dv
