"""Decoder assembly: forward, prefill and decode over the stacked period
layout — port of ``repro/models/transformer.py:139-454``.

The params and caches keep the reference's layout (layers of whole periods
stacked along a leading ``n_periods`` axis, the rest unrolled as
``remainder/r<i>``); the reference's ``lax.scan`` over periods becomes a
Python loop over slices of the stacked tensors. Every layer kind of the
reference runs: a mixer (global or windowed self-attention, gated
cross-attention onto a context ``ctx`` — image patches, or the encoder's
output from ``encode`` — or a Mamba block), then, unless the FFN is
``none``, ``norm2`` and an MLP or a MoE FFN (``models/moe.py``), as
jamba-1.5-large-398b's Mamba layers have. An unknown mixer or FFN raises
``ValueError``. ``impl`` picks the kernels (``kernels/ops.py``).

Given a ``mesh`` (``launch/mesh.py``), the params' leaves may be DTensors
(``launch/sharding.distribute``): every dense leaf is gathered whole on
each rank, and each MoE FFN runs on the shard-local path
(``moe.moe_apply``) over this rank's expert slices (``local_params``).
The tokens, the context, the cache and the activations are this rank's
own rows, as plain tensors. Without a mesh nothing of this runs."""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import (ATTN, ATTN_LOCAL, CROSS, MAMBA, MLP,
                                       MOE, NONE, ModelConfig)
from repro_torch.models.layers import embed_apply, mlp_apply, rms_norm


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           impl: str = "auto") -> torch.Tensor:
    """Encoder stack over precomputed modality-frontend frames (enc-dec):
    (B,T,d) -> (B,T,d), layers ``e0`` .. ``e<n-1>`` in numeric order."""
    x = frames
    enc = params["encoder"]
    for i in range(cfg.encoder_layers):
        lp = enc[f"e{i}"]
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + attn_lib.encoder_self_attention(lp["mixer"], cfg, h, impl)
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + mlp_apply(lp["ffn"], h2, cfg.act, impl=impl)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _theta_for(cfg: ModelConfig, mixer: str) -> float:
    if mixer == ATTN and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _kind(cfg: ModelConfig, j: int) -> tuple[str, str]:
    return (cfg.layer_pattern[j % len(cfg.layer_pattern)],
            cfg.ffn_pattern[j % len(cfg.ffn_pattern)])


def _apply_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor, mixer: str,
                 ffn: str, *, positions: torch.Tensor,
                 ctx: torch.Tensor | None, cache: dict | None,
                 impl: str, mesh=None
                 ) -> tuple[torch.Tensor, dict, torch.Tensor | None]:
    """One residual layer: the mixer, then ``norm2`` and the FFN unless it
    is ``none``. Returns (x, state, MoE aux loss): the state is the
    prefill K/V or Mamba state when ``cache`` is None, else the decode
    cache updated in place, and ``{}`` for cross-attention, which keeps no
    cache; the aux is None but for MoE layers."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if mixer == MAMBA:
        if cache is None:
            o, state = mamba_lib.mamba_forward(lp["mixer"], cfg, h,
                                               return_state=True, impl=impl)
        else:
            o, new = mamba_lib.mamba_decode_step(lp["mixer"], cfg, h, cache,
                                                 impl=impl)
            for name, leaf in new.items():
                cache[name].copy_(leaf)
            state = cache
    elif mixer == CROSS:
        o = attn_lib.cross_attention(lp["mixer"], cfg, h, ctx, impl)
        o = o * torch.tanh(lp["gate"].float()).to(o.dtype)
        state = {}
    elif mixer in (ATTN, ATTN_LOCAL):
        window = cfg.sliding_window if mixer == ATTN_LOCAL else 0
        o, state = attn_lib.self_attention(
            lp["mixer"], cfg, h, positions=positions, window=window,
            theta=_theta_for(cfg, mixer), cache=cache, impl=impl)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    x = x + o
    if ffn == NONE:
        return x, state, None
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    if ffn == MOE:
        f, aux = moe_lib.moe_apply(lp["ffn"], cfg, h2, impl=impl, mesh=mesh)
        return x + f, state, aux
    if ffn == MLP:
        return x + mlp_apply(lp["ffn"], h2, cfg.act, impl=impl), state, None
    raise ValueError(f"unknown ffn {ffn!r}")


def _slots(cfg: ModelConfig):
    """(key, i, mixer, ffn) for every layer in model order: ``key`` is
    ``l<j>`` of period ``i``, or ``r<i>`` of the remainder with ``i``
    None."""
    pat = cfg.layer_pattern
    for i in range(cfg.n_periods):
        for j in range(len(pat)):
            yield (f"l{j}", i) + _kind(cfg, j)
    base = cfg.n_periods * len(pat)
    for i in range(cfg.n_remainder):
        yield (f"r{i}", None) + _kind(cfg, base + i)


def _layer_params(params: dict, key: str, i: int | None) -> dict:
    if i is None:
        return params["remainder"][key]
    return _period_slice(params["periods"][key], i)


def _period_slice(tree: dict, i: int) -> dict:
    return {k: _period_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def local_params(params: dict, mesh) -> dict:
    """``params`` as this rank's plain tensors on ``mesh``: each dense
    DTensor leaf gathered whole (``full_tensor``), each MoE FFN (a dict
    with a ``router``) as this rank's expert slices
    (``moe.expert_slices``)."""
    from torch.distributed.tensor import DTensor

    def one(v):
        if isinstance(v, dict):
            return moe_lib.expert_slices(v, mesh) if "router" in v else \
                {k: one(u) for k, u in v.items()}
        return v.full_tensor() if isinstance(v, DTensor) else v
    return one(params)


def _lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor,
             impl: str) -> torch.Tensor:
    if cfg.tie_embeddings:   # x @ embed.T, reading the table in place
        logits = ops.matmul(x, params["embed"], b_transposed=True, impl=impl)
    else:
        logits = ops.matmul(x, params["lm_head"], impl=impl)
    if cfg.padded_vocab != cfg.vocab:  # mask the padded vocab tail
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, attn_lib.NEG_INF)
    return logits


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   ctx: torch.Tensor | None = None, impl: str = "auto",
                   mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced full-sequence pass up to the final norm -> ((B, S,
    d_model) hidden states, the MoE aux loss summed over layers over
    max(1, MoE layers)): the reference's ``forward(..., return_hidden=
    True)`` (``transformer.py:200-246``), whose hidden states the train
    loss folds into a chunked LM head. ``ctx`` is what cross-attention
    layers attend to: image patches, or the output of ``encode``.

    With ``cfg.remat == "full"`` and grad enabled, each whole period of
    layers runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of its period body, ``:222-223``): only its input
    is kept, and its layers run again in the backward pass; remainder
    layers are not recomputed, as in the reference. A stacked leaf under
    ``periods/`` may be given as the sequence of its period slices (the
    train step does, so that each period's gradient is a tensor of its
    own)."""
    if mesh is not None:
        params = local_params(params, mesh)
    B, S = tokens.shape
    x = embed_apply(params["embed"], tokens, cfg.embed_scale, cfg.d_model)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    aux = x.new_zeros((), dtype=torch.float32)

    def run(x, aux, slots):
        for key, i, mixer, ffn in slots:
            x, _, a = _apply_layer(_layer_params(params, key, i), cfg, x,
                                   mixer, ffn, positions=positions, ctx=ctx,
                                   cache=None, impl=impl, mesh=mesh)
            if a is not None:
                aux = aux + a
        return x, aux

    slots = list(_slots(cfg))
    per = len(cfg.layer_pattern)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for i in range(cfg.n_periods):
        period = slots[i * per:(i + 1) * per]
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                run, x, aux, period, use_reentrant=False)
        else:
            x, aux = run(x, aux, period)
    x, aux = run(x, aux, slots[cfg.n_periods * per:])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    n_moe = max(1, sum(1 for _, f in cfg.layer_kinds() if f == MOE))
    return x, aux / n_moe


def forward_with_aux(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                     ctx: torch.Tensor | None = None, impl: str = "auto",
                     mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced full-sequence pass -> ((B, S, padded_vocab) logits,
    the MoE aux loss), as the reference's ``forward`` returns them."""
    if mesh is not None:
        params = local_params(params, mesh)
    x, aux = forward_hidden(params, cfg, tokens, ctx, impl, mesh)
    return _lm_head(params, cfg, x, impl), aux


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            ctx: torch.Tensor | None = None, impl: str = "auto",
            mesh=None) -> torch.Tensor:
    """Teacher-forced full-sequence pass -> (B, S, padded_vocab) logits
    (``forward_with_aux`` without the aux loss)."""
    return forward_with_aux(params, cfg, tokens, ctx, impl, mesh)[0]


# ----------------------------------------------------------------- caches

def _buffer_width(cfg: ModelConfig, mixer: str, S: int) -> int:
    if mixer == ATTN or not cfg.sliding_window:
        return S
    return min(cfg.sliding_window, S)


def _empty_buffer(cfg: ModelConfig, B: int, W: int, device) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((B, cfg.n_kv_heads, W, hd), dtype=torch.bfloat16,
                         device=device),
        "v": torch.zeros((B, cfg.n_kv_heads, W, hd), dtype=torch.bfloat16,
                         device=device),
        "pos": torch.full((B, W), -1, dtype=torch.int32, device=device),
    }


def _assemble(cfg: ModelConfig, t: torch.Tensor, per_layer: dict) -> dict:
    """Cache tree in the reference's layout from {(key, i): layer cache},
    stacking each leaf of a period's layers along a leading axis."""
    cache: dict = {"t": t}
    if cfg.n_periods > 0:
        cache["periods"] = {
            f"l{j}": {name: torch.stack([per_layer[(f"l{j}", i)][name]
                                         for i in range(cfg.n_periods)])
                      for name in per_layer[(f"l{j}", 0)]}
            for j in range(len(cfg.layer_pattern))}
    if cfg.n_remainder > 0:
        cache["remainder"] = {f"r{i}": per_layer[(f"r{i}", None)]
                              for i in range(cfg.n_remainder)}
    return cache


def init_cache(cfg: ModelConfig, B: int, S: int, device=None) -> dict:
    """Decode cache sized for a context of S tokens."""
    bufs = {}
    for key, i, mixer, _ in _slots(cfg):
        if mixer == MAMBA:
            bufs[(key, i)] = mamba_lib.mamba_init_cache(cfg, B, device)
        elif mixer == CROSS:
            bufs[(key, i)] = {}
        elif mixer in (ATTN, ATTN_LOCAL):
            bufs[(key, i)] = _empty_buffer(
                cfg, B, _buffer_width(cfg, mixer, S), device)
        else:
            raise ValueError(f"unknown mixer {mixer!r}")
    return _assemble(cfg, torch.zeros((B,), dtype=torch.int32, device=device),
                     bufs)


def _kv_to_buffer(kv: dict, W: int) -> dict:
    """Convert full-sequence K/V (B,S,KV,hd) into the rolling decode buffer
    layout (B,KV,W,hd) + per-slot absolute positions."""
    k, v, pos = kv["k"], kv["v"], kv["pos"]
    B, S, KV, hd = k.shape
    take = min(W, S)
    slots = torch.arange(S - take, S, device=k.device) % W
    bk = torch.zeros((B, KV, W, hd), dtype=k.dtype, device=k.device)
    bv = torch.zeros((B, KV, W, hd), dtype=v.dtype, device=v.device)
    bpos = torch.full((B, W), -1, dtype=torch.int32, device=k.device)
    bk[:, :, slots] = k[:, S - take:].transpose(1, 2)
    bv[:, :, slots] = v[:, S - take:].transpose(1, 2)
    bpos[:, slots] = pos[:, S - take:]
    return {"k": bk, "v": bv, "pos": bpos}


# ---------------------------------------------------------------- prefill

def prefill_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   ctx: torch.Tensor | None = None,
                   cache_len: int | None = None, impl: str = "auto",
                   mesh=None) -> tuple[torch.Tensor, dict]:
    """``prefill`` up to the final norm: (B,S,d_model) hidden states and
    the decode cache, so that a caller can run the LM head on the rows it
    needs."""
    if mesh is not None:
        params = local_params(params, mesh)
    B, S = tokens.shape
    CL = cache_len or S
    x = embed_apply(params["embed"], tokens, cfg.embed_scale, cfg.d_model)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    bufs = {}
    for key, i, mixer, ffn in _slots(cfg):
        x, state, _ = _apply_layer(_layer_params(params, key, i), cfg, x,
                                   mixer, ffn, positions=positions, ctx=ctx,
                                   cache=None, impl=impl, mesh=mesh)
        bufs[(key, i)] = state if mixer in (MAMBA, CROSS) else \
            _kv_to_buffer(state, _buffer_width(cfg, mixer, CL))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    t = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return x, _assemble(cfg, t, bufs)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            ctx: torch.Tensor | None = None, cache_len: int | None = None,
            impl: str = "auto", mesh=None) -> tuple[torch.Tensor, dict]:
    """Process a prompt, returning (logits, decode cache). Without
    ``cache_len`` every buffer is S wide, as in the reference."""
    if mesh is not None:
        params = local_params(params, mesh)
    x, cache = prefill_hidden(params, cfg, tokens, ctx, cache_len, impl,
                              mesh)
    return _lm_head(params, cfg, x, impl), cache


# ----------------------------------------------------------------- decode

def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, ctx: torch.Tensor | None = None,
                impl: str = "auto", mesh=None) -> tuple[torch.Tensor, dict]:
    """One greedy decode step. token: (B, 1) int32. Writes the token's K/V
    into ``cache``'s attention buffers and the new ``h`` and ``conv`` into
    its Mamba layers, all in place (the reference returns new arrays; the
    port saves the copy); the returned cache shares them and carries
    ``t + 1``. Cross-attention layers attend to the whole ``ctx``."""
    if mesh is not None:
        params = local_params(params, mesh)
    x = embed_apply(params["embed"], token, cfg.embed_scale, cfg.d_model)
    positions = cache["t"][:, None]                            # (B,1)
    for key, i, mixer, ffn in _slots(cfg):
        x, _, _ = _apply_layer(_layer_params(params, key, i), cfg, x, mixer,
                               ffn, positions=positions, ctx=ctx,
                               cache=_layer_params(cache, key, i), impl=impl,
                               mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = dict(cache, t=cache["t"] + 1)
    return _lm_head(params, cfg, x, impl), new_cache
