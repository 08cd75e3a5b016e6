"""Analytic per-cell FLOP and HBM-traffic models — the port's copy of
``repro.launch.analytic``, value for value.

The fused-traffic estimate used as the roofline's memory term rests on
these assumptions:

  * weights stream from HBM once per use: forward + remat-recompute +
    backward = 3 reads per microbatch (training); once per step (serving);
  * attention runs flash-style: no S x T score traffic, only q/k/v/o
    streams;
  * layer-boundary activations: write + (remat) re-read + backward read;
  * optimizer: moments read+write, grads write+read (ZeRO-local);
  * decode: full KV/SSM-state cache read + one-slot write per step.

Every term is per device on the (16, 16) production mesh (``MODEL_AX``,
``DP_AX``). ``arch`` is a name of ``configs.ARCH_IDS`` or a
``ModelConfig``, ``shape`` a name of ``settings.SHAPES`` or a dict of the
same keys, and ``model_ax``/``dp_ax`` take another mesh: a single card is
``model_ax=1, dp_ax=1``. The defaults give the reference's numbers.
"""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.launch.settings import SHAPES, settings_for
from repro_torch.models.config import (ATTN, ATTN_LOCAL, CROSS, MAMBA, MLP,
                                      MOE, ModelConfig)

MODEL_AX = 16
DP_AX = 16
CHIPS = MODEL_AX * DP_AX


def resolve_config(arch) -> ModelConfig:
    return arch if isinstance(arch, ModelConfig) else get_config(arch)


def resolve_shape(shape) -> dict:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _per_layer_act_bytes(cfg, B_loc: int, S: int, train: bool) -> float:
    """Fused activation traffic per layer (bytes)."""
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    io = 2  # bf16
    total = 0.0
    for mixer, ffn in cfg.layer_kinds():
        t = 4 * d                      # residual in/out, norm rw
        if mixer in (ATTN, ATTN_LOCAL, CROSS):
            t += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd * 2  # qkv w + r
            t += cfg.n_heads * hd * 2                         # attn out
        elif mixer == MAMBA:
            t += 2 * cfg.d_inner * 3                          # xz, conv, y
            t += cfg.ssm_state * 4                            # B,C streams
        if ffn == MLP:
            t += f * 4                                        # gate/up/act/dn
        elif ffn == MOE:
            t += cfg.top_k * cfg.capacity_factor * f * 4 + cfg.n_experts
        total += t
    mult = 3.0 if train else 1.0       # fwd + remat re-fwd + bwd reads
    return total * B_loc * S * io * mult / max(cfg.n_layers, 1) \
        * cfg.n_layers


def _param_bytes_local(cfg, model_ax: int = MODEL_AX) -> float:
    return cfg.param_count() * 2 / model_ax     # bf16, TP-sharded reads


def _active_param_bytes_local(cfg, model_ax: int = MODEL_AX) -> float:
    return cfg.active_param_count() * 2 / model_ax


def _cache_bytes_local(cfg, B: int, S: int, model_ax: int = MODEL_AX,
                       dp_ax: int = DP_AX) -> float:
    hd = cfg.resolved_head_dim
    total = 0.0
    for mixer, _ in cfg.layer_kinds():
        if mixer in (ATTN, CROSS):
            total += 2 * cfg.n_kv_heads * hd * S * 2
        elif mixer == ATTN_LOCAL:
            W = min(cfg.sliding_window or S, S)
            total += 2 * cfg.n_kv_heads * hd * W * 2
        elif mixer == MAMBA:
            total += cfg.d_inner * cfg.ssm_state * 4
    # batch x model or seq-shard
    shards = model_ax * dp_ax if (B >= dp_ax) else dp_ax
    return total * B / shards


def analytic_bytes_per_device(arch, shape, *, model_ax: int = MODEL_AX,
                              dp_ax: int = DP_AX) -> float:
    cfg = resolve_config(arch)
    st = settings_for(cfg.name)
    sh = resolve_shape(shape)
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    B_loc = max(1, B // dp_ax)
    p_loc = _param_bytes_local(cfg, model_ax)

    if kind == "train":
        mb = st.microbatches
        weights = 3.0 * p_loc * mb          # fwd+re-fwd+bwd per microbatch
        grads = 2.0 * p_loc
        # fp32 m+v rw, ZeRO-local
        opt = 16.0 * cfg.param_count() / (model_ax * dp_ax)
        acts = _per_layer_act_bytes(cfg, B_loc // mb, S, True) * mb
        head = 4.0 * (B_loc * S) * cfg.padded_vocab / model_ax * 2
        return weights + grads + opt + acts + head
    if kind == "prefill":
        weights = _active_param_bytes_local(cfg, model_ax)
        acts = _per_layer_act_bytes(cfg, B_loc, S, False)
        cache_w = _cache_bytes_local(cfg, B, S, model_ax, dp_ax)
        return weights + acts + cache_w
    # decode: one token over the full cache
    weights = _active_param_bytes_local(cfg, model_ax)
    cache_rw = 1.1 * _cache_bytes_local(cfg, B, S, model_ax, dp_ax)
    acts = _per_layer_act_bytes(cfg, B_loc, 1, False)
    return weights + cache_rw + acts


def analytic_flops_global(arch, shape) -> float:
    """Hardware FLOPs incl. attention quadratics, remat and CE (cross-check
    band for the dry run's model FLOPs)."""
    cfg = resolve_config(arch)
    sh = resolve_shape(shape)
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    T = B * (S if kind != "decode" else 1)
    n = cfg.active_param_count()
    base = 2.0 * n * T
    # attention quadratic term (computed full S x T then masked)
    attn = 0.0
    hd = cfg.resolved_head_dim
    for mixer, _ in cfg.layer_kinds():
        if mixer in (ATTN, ATTN_LOCAL):
            ctx = S if kind != "decode" else S
            q = S if kind != "decode" else 1
            attn += 4.0 * B * q * ctx * cfg.n_heads * hd
        elif mixer == CROSS:
            ctxlen = cfg.image_tokens or cfg.encoder_frames
            q = S if kind != "decode" else 1
            attn += 4.0 * B * q * ctxlen * cfg.n_heads * hd
    if kind == "train":
        return 3.0 * (base + attn) + 1.0 * (base + attn)  # bwd 2x + remat
    return base + attn
