"""Grouped-query attention with RoPE, sliding windows, the rolling decode
buffer, cross-attention and bidirectional encoder attention — port of
``repro/models/attention.py:31-227``.

Attention over whole sequences (prefill self-attention, cross-attention at
prefill and decode alike, encoder self-attention) runs the flash kernel
for CUDA tensors and ``_attend``'s direct path otherwise (the CPU, or
``impl="torch"``). Decode self-attention over the rolling buffer stays
plain PyTorch, as the reference computes it with einsums outside any
Pallas kernel. Every projection goes through ``ops.matmul``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

NEG_INF = -2.0e38


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,KV,G,D), k: (B,T,KV,D) -> (B,KV,G,S,T)."""
    return torch.einsum("bskgd,btkd->bkgst", q, k)


def _gqa_out(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B,KV,G,S,T), v: (B,T,KV,D) -> (B,S,KV,G,D)."""
    return torch.einsum("bkgst,btkd->bskgd", w, v)


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    s = scores.float()
    s = s - s.amax(dim=-1, keepdim=True)
    w = torch.exp(s)
    return w / w.sum(dim=-1, keepdim=True)


def _attend(q, k, v, qpos, kpos, window: int) -> torch.Tensor:
    """The reference's direct path (``attention.py:128-138``): scores in
    the input dtype, softmax in fp32; causal by absolute positions, or
    every key visible when ``qpos`` is None. The reference takes its
    blockwise path once S·T exceeds 4096², which no served shape reaches.
    q: (B,S,KV,G,D) scaled; k/v: (B,T,KV,D); qpos (B|1,S), kpos (B|1,T).
    Returns (B,S,H*D)."""
    B, S, KV, G, D = q.shape
    scores = _gqa_scores(q, k)
    if qpos is not None:
        tp = kpos[:, None, None, None, :]
        qp = qpos[:, None, None, :, None]
        mask = tp <= qp
        if window:
            mask &= (qp - tp) < window
        scores = torch.where(mask, scores, NEG_INF)
    w = _softmax(scores).to(v.dtype)
    return _gqa_out(w, v).reshape(B, S, KV * G * D)


def _attend_sequence(q, k, v, impl: str, positions=None,
                     window: int = 0) -> torch.Tensor:
    """Attention of whole sequences: the flash kernel for CUDA tensors,
    else ``_attend``. q: (B,S,H,D) scaled; k/v: (B,T,KV,D); ``positions``
    are arange(S) for q and k (the kernel's causal rule by index is then
    the absolute-position mask), or None for no mask. Returns (B,S,H*D)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if ops.uses_kernel(q, impl):
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=positions is not None, window=window, scale=1.0,
            impl=impl)
        return o.transpose(1, 2).reshape(B, S, H * D)
    return _attend(q.view(B, S, KV, H // KV, D), k, v, positions, positions,
                   window)


def self_attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,          # (B|1, S) absolute positions of queries
    window: int = 0,                  # 0 => global causal
    theta: float | None = None,
    cache: Optional[dict] = None,     # decode: {"k","v","pos"} rolling buffers
    impl: str = "auto",
) -> tuple[torch.Tensor, dict]:
    """Causal (optionally sliding-window) GQA self-attention.

    Prefill: cache is None, positions are ``arange(S)`` -> attends within
    the sequence, returns the (rope-applied) K/V so the caller can build a
    cache. Decode: cache given, S == 1 -> writes this token's K/V into the
    rolling buffer **in place** (the reference returns new arrays; the
    port saves the copy) and attends over it.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    th = cfg.rope_theta if theta is None else theta

    q = ops.matmul(x, p["wq"], impl=impl).view(B, S, H, hd)
    k = ops.matmul(x, p["wk"], impl=impl).view(B, S, KV, hd)
    v = ops.matmul(x, p["wv"], impl=impl).view(B, S, KV, hd)
    q = apply_rope(q, positions, th, cfg.partial_rotary)
    k = apply_rope(k, positions, th, cfg.partial_rotary)
    q = q * (hd ** -0.5)

    if cache is None:
        o = _attend_sequence(q, k, v, impl, positions, window)
        new_cache = {"k": k, "v": v, "pos": positions.to(torch.int32)}
        return ops.matmul(o, p["wo"], impl=impl), new_cache

    # ---------------- decode: S == 1, rolling buffer of width Wbuf
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]      # (B,KV,W,hd)
    Wbuf = ck.shape[2]
    qpos = positions[:, 0]                                    # (B,)
    slot = (qpos % Wbuf).long()
    bidx = torch.arange(B, device=x.device)
    ck[bidx, :, slot] = k[:, 0]
    cv[bidx, :, slot] = v[:, 0]
    cpos[bidx, slot] = qpos.to(torch.int32)
    scores = _gqa_scores(q.view(B, 1, KV, G, hd), ck.transpose(1, 2))
    tp = cpos[:, None, None, None, :]
    qp = qpos[:, None, None, None, None]
    mask = (tp >= 0) & (tp <= qp)
    if window:
        mask &= (qp - tp) < window
    scores = torch.where(mask, scores, NEG_INF)
    w = _softmax(scores).to(v.dtype)
    o = _gqa_out(w, cv.transpose(1, 2)).reshape(B, 1, H * hd)
    return ops.matmul(o, p["wo"], impl=impl), {"k": ck, "v": cv, "pos": cpos}


def cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    ctx: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Cross-attention onto a static context (image patches / encoder out).
    No positional rotation (context is an unordered/pre-encoded set). The
    context's K/V are projected on every call, at decode too (S = 1), as
    in the reference. x: (B,S,d); ctx: (B,T,d)."""
    B, S, _ = x.shape
    T = ctx.shape[1]
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = ops.matmul(x, p["wq"], impl=impl).view(B, S, H, hd) * (hd ** -0.5)
    k = ops.matmul(ctx, p["wk"], impl=impl).view(B, T, KV, hd)
    v = ops.matmul(ctx, p["wv"], impl=impl).view(B, T, KV, hd)
    return ops.matmul(_attend_sequence(q, k, v, impl), p["wo"], impl=impl)


def encoder_self_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           impl: str = "auto") -> torch.Tensor:
    """Bidirectional (non-causal) self-attention for encoder stacks, RoPE
    on arange(S) for q and k."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q = ops.matmul(x, p["wq"], impl=impl).view(B, S, H, hd)
    k = ops.matmul(x, p["wk"], impl=impl).view(B, S, KV, hd)
    v = ops.matmul(x, p["wv"], impl=impl).view(B, S, KV, hd)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.partial_rotary)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.partial_rotary)
    q = q * (hd ** -0.5)
    return ops.matmul(_attend_sequence(q, k, v, impl), p["wo"], impl=impl)
