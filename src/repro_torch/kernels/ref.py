"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what each kernel is held against on the card.

Counterparts of ``repro/kernels/ref.py``, with differences of contract
that the kernels share:

- matmul also takes B as (N, K);
- flash attention follows the Pallas kernel (top-left causal rule by
  index, unnormalised P rounded to V's dtype before P.V, then divided by
  the fp32 denominator) and adds native GQA, a sliding window and a score
  scale;
- the selective scan also returns its final state;
- the STREAM triad rounds as the Pallas kernel does, not as the JAX
  ``triad_ref``: alpha is rounded to fp32 first; in fp32, b + alpha c is
  rounded once (XLA contracts the kernel body into an FMA, the JAX
  reference rounds twice); in bf16, alpha is rounded on to bf16 and the
  product and the sum are each rounded to bf16;
- the Jacobi-2d sweep sums as the Pallas kernel does, not as the JAX
  ``jacobi2d_ref``: the five values in fp32 in the order mid, above,
  below, left, right, times 0.2 in fp32, rounded once to the dtype (the
  JAX reference rounds every add in bf16).
"""

from __future__ import annotations

import math

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


def _scores(q, k, causal, window, scale):
    """fp32 scores q.k * scale as (B,KV,G,S,T), masked to NEG_INF, and the
    mask."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, S, D).float() * scale
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float())
    mask = attention_mask(S, T, causal, window, q.device)
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None, return_lse: bool = False):
    """q: (B,H,S,D); k, v: (B,KV,T,D) with H % KV == 0 -> (B,H,S,D).
    Scores q.k * scale (D^-0.5 by default) in fp32. With ``return_lse``
    also the fp32 row log-sum-exp of the scaled scores, (B,H,S): m + log l,
    -inf for a row that sees no key."""
    B, H, S, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    s, mask = _scores(q, k, causal, window, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), v.float())
    o = (acc / l.clamp_min(1e-30)).reshape(B, H, S, D).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(l)).reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            window: int = 0, scale: float | None = None):
    """The backward pass of ``flash_attention_ref`` from its output ``o``
    and row log-sum-exp ``lse``, in fp32 (FlashAttention-2's form): with
    P = exp(s - lse) on the visible pairs,

        dV = P^T dO  (P rounded to V's dtype, as the forward rounds it),
        Delta = rowsum(dO * O),  dS = P * (dO V^T - Delta),
        dQ = scale dS K,  dK = scale dS^T Q,

    dK and dV summed over the G q heads of a KV head. Returns (dq, dk, dv)
    in the dtypes of q, k and v."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = D ** -0.5 if scale is None else scale
    s, mask = _scores(q, k, causal, window, scale)
    lse5 = lse.reshape(B, KV, G, S, 1).float()
    p = torch.where(mask, torch.exp(s - lse5), 0.0)
    do5 = do.reshape(B, KV, G, S, D).float()
    dv = torch.einsum("bkgst,bkgsd->bktd", p.to(v.dtype).float(), do5)
    delta = (do5 * o.reshape(B, KV, G, S, D).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bkgsd,bktd->bkgst", do5, v.float())
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bkgst,bktd->bkgsd", ds, k.float())
    dk = scale * torch.einsum("bkgst,bkgsd->bktd", ds,
                              q.reshape(B, KV, G, S, D).float())
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def mamba_scan_bwd_ref(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, x: torch.Tensor, dy: torch.Tensor,
                       dh_last: torch.Tensor | None = None):
    """The backward pass of ``mamba_scan_ref``, written out: the forward's
    states, then a reverse-time loop with an explicit fp32 state. With
    a_t = exp(dt_t A), u_t = dt_t x_t and g_t the gradient of h_t,

        g_t = dy_t C_t + a_{t+1} g_{t+1}   (g_S carries dh_last, or 0),
        dC_t = sum_d dy_{t,d} h_{t,d},   dB_t = sum_d g_{t,d} u_{t,d},
        du_t = sum_n g_{t,n} B_{t,n},    dx_t = dt_t du_t,
        d dt_t = sum_n g_{t,n} A_n a_{t,n} h_{t-1,n} + x_t du_t,
        dA = sum_{b,t} g_t dt_t a_t h_{t-1}.

    dy: (Bt,S,D) like y; dh_last: (Bt,D,N) or None. Returns (d dt, dA,
    dB, dC, dx) in the dtypes of dt, A, B, C and x."""
    Bt, S, D = x.shape
    f32 = torch.float32
    Af, dtf, xf = A.float(), dt.float(), x.float()
    Bf, Cf, dyf = B.float(), C.float(), dy.float()
    hs = torch.empty((S, Bt, D, A.shape[1]), dtype=f32, device=x.device)
    h = torch.zeros((Bt, D, A.shape[1]), dtype=f32, device=x.device)
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        hs[t] = h
    carry = (torch.zeros_like(h) if dh_last is None
             else dh_last.to(f32).clone())
    d_dt = torch.empty((Bt, S, D), dtype=f32, device=x.device)
    dx = torch.empty((Bt, S, D), dtype=f32, device=x.device)
    dB = torch.empty((Bt, S, A.shape[1]), dtype=f32, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros_like(Af)
    for t in reversed(range(S)):
        dt_t, x_t, dy_t = dtf[:, t], xf[:, t], dyf[:, t]
        a = torch.exp(dt_t[..., None] * Af)                     # (Bt,D,N)
        g = dy_t[..., None] * Cf[:, t, None, :] + carry
        dC[:, t] = torch.einsum("bd,bdn->bn", dy_t, hs[t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
        du = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        gah = g * a * (hs[t - 1] if t else torch.zeros_like(h))
        d_dt[:, t] = torch.einsum("bdn,dn->bd", gah, Af) + x_t * du
        dx[:, t] = dt_t * du
        dA += (gah * dt_t[..., None]).sum(0)
        carry = a * g
    return (d_dt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype),
            dx.to(x.dtype))


def triad_alpha(alpha: float, dtype: torch.dtype) -> float:
    """alpha as the triad multiplies by it: rounded to fp32, as the Pallas
    launcher passes it, and for bf16 on to bf16 (``stream_triad.py:22``)."""
    a = torch.tensor(alpha, dtype=torch.float32)
    return (a.to(torch.bfloat16) if dtype == torch.bfloat16 else a).item()


TRIAD_CHUNK = 1 << 24   # elements per fp64 pass of the fp32 triad


def triad_ref(b: torch.Tensor, c: torch.Tensor, alpha: float) -> torch.Tensor:
    """STREAM triad a = b + alpha c, b and c of one shape in fp32 or bf16.

    fp32: fl32(alpha c + b), one rounding. alpha c is exact in fp64; the
    fp64 sum is made round-to-odd from its exact error (TwoSum), and
    rounding that to fp32 gives the correctly rounded result (53 >= 24 + 2
    bits). It runs in chunks of TRIAD_CHUNK elements to bound its fp64
    temporaries. bf16: two bf16 roundings, product then sum."""
    alpha = triad_alpha(alpha, b.dtype)
    if b.dtype == torch.bfloat16:
        return b + c * torch.tensor(alpha, dtype=torch.bfloat16)
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    flat_b, flat_c, flat_out = b.reshape(-1), c.reshape(-1), out.view(-1)
    for i in range(0, flat_b.numel(), TRIAD_CHUNK):
        cb = flat_b[i:i + TRIAD_CHUNK].double()
        p = flat_c[i:i + TRIAD_CHUNK].double().mul_(alpha)   # exact
        s = p + cb
        bv = s - p
        av = s - bv
        err = cb.sub_(bv).add_(p.sub_(av))        # p + cb == s + err exactly
        bits = s.view(torch.int64)
        even_inexact = ((bits & 1) == 0) & (err != 0) & torch.isfinite(err)
        toward = torch.copysign(torch.full_like(s, math.inf), err)
        s = torch.where(even_inexact, torch.nextafter(s, toward), s)
        flat_out[i:i + TRIAD_CHUNK] = s.float()
    return out


def jacobi2d_ref(a: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep over a 2-D grid: interior cells become
    0.2 (self + above + below + left + right), summed in fp32 in that
    order and rounded once to a's dtype; boundary rows and columns pass
    through (all of the grid when R or C < 3)."""
    out = a.clone()
    if a.shape[0] < 3 or a.shape[1] < 3:
        return out
    x = a.float()
    s = x[1:-1, 1:-1] + x[:-2, 1:-1]
    s += x[2:, 1:-1]
    s += x[1:-1, :-2]
    s += x[1:-1, 2:]
    s *= torch.tensor(0.2, dtype=torch.float32)
    out[1:-1, 1:-1] = s
    return out
