"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what each kernel is held against on the card.

Counterparts of ``repro/kernels/ref.py:22-63``, with three differences of
contract that the kernels share: matmul also takes B as (N, K), flash
attention follows the Pallas kernel (top-left causal rule by index,
unnormalised P rounded to V's dtype before P.V, then divided by the fp32
denominator) and adds native GQA, a sliding window and a score scale, and
the selective scan also returns its final state.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               b_transposed: bool = False) -> torch.Tensor:
    """C = A @ B with fp32 accumulation, in A's dtype. A: (M, K); B: (K, N),
    or (N, K) when ``b_transposed``. On the card the caller keeps TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    bb = b.t() if b_transposed else b
    return torch.matmul(a.float(), bb.float()).to(a.dtype)


def attention_mask(S: int, T: int, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """(S, T) bool: key j is visible to query i. Causal is the top-left rule
    by index (j <= i), the Pallas kernel's; ``window`` > 0 also requires
    i - j < window."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window:
        mask &= (i - j) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B,H,S,D); k, v: (B,KV,T,D) with H % KV == 0 -> (B,H,S,D).
    Scores q.k * scale (D^-0.5 by default) in fp32."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, H // KV, S, D).float() * scale
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float())
    mask = attention_mask(S, T, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), v.float())
    o = acc / l.clamp_min(1e-30)
    return o.reshape(B, H, S, D).to(q.dtype)


def mamba_scan_ref(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan, sequential over time with an fp32 state from h_0 = 0:

        h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t

    dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N) -> (y (Bt,S,D) in x's dtype,
    h_last (Bt,D,N) fp32, the state after step S)."""
    Bt, S, D = x.shape
    out_dtype = x.dtype
    A, dt, x = A.float(), dt.float(), x.float()
    B, C = B.float(), C.float()
    h = torch.zeros((Bt, D, A.shape[1]), dtype=torch.float32, device=x.device)
    ys = torch.empty((Bt, S, D), dtype=torch.float32, device=x.device)
    for t in range(S):
        dt_t = dt[:, t]
        h = torch.exp(dt_t[..., None] * A) * h \
            + (dt_t * x[:, t])[..., None] * B[:, t, None, :]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    return ys.to(out_dtype), h
