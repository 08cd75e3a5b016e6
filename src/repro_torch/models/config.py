"""Unified model configuration covering all assigned architecture families:
dense / GQA transformers, MoE, Mamba (SSM), hybrid, VLM (cross-attention),
and encoder-decoder.

A copy of ``repro.models.config`` (pure Python): the port keeps its own so
that it never imports the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Optional

# layer kinds usable in `layer_pattern`
ATTN = "attn"            # global causal self-attention
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MAMBA = "mamba"          # mamba1 SSM block
CROSS = "cross"          # self-attention + gated cross-attention (VLM)

# ffn kinds usable in `ffn_pattern`
MLP = "mlp"
MOE = "moe"
NONE = "none"            # mamba blocks carry their own mixing; no FFN


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    d_ff: int
    n_heads: int = 0                   # 0 => attention-free (pure SSM)
    n_kv_heads: int = 0
    head_dim: int = 0                  # 0 => d_model // n_heads
    layer_pattern: tuple[str, ...] = (ATTN,)
    ffn_pattern: tuple[str, ...] = (MLP,)
    # --- attention ---
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0     # gemma3: separate theta for globals
    partial_rotary: float = 1.0        # chatglm3 "2d RoPE": rotate half dims
    sliding_window: int = 0            # for ATTN_LOCAL layers
    embed_scale: bool = False          # gemma: scale embeds by sqrt(d_model)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- mamba ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                   # 0 => ceil(d_model / 16)
    # --- encoder (enc-dec archs) ---
    encoder_layers: int = 0
    encoder_frames: int = 1024         # stub modality frontend length
    # --- VLM ---
    image_tokens: int = 0              # stub patch-embedding count
    # --- numerics / misc ---
    mlp_gated: bool = True             # False => classic 2-matrix MLP
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    remat: str = "full"                # "none" | "full" (per layer period)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a 256-multiple so the vocab dim shards
        evenly on any mesh axis (49155 -> 49408 etc.); logits over the pad
        are masked to -inf."""
        return -(-self.vocab // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers % len(self.layer_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_vlm(self) -> bool:
        return self.image_tokens > 0

    @property
    def attention_free(self) -> bool:
        return all(k == MAMBA for k in self.layer_pattern)

    def layer_kinds(self) -> list[tuple[str, str]]:
        """Full per-layer (mixer, ffn) kind list."""
        kinds = []
        for i in range(self.n_layers):
            kinds.append((self.layer_pattern[i % len(self.layer_pattern)],
                          self.ffn_pattern[i % len(self.ffn_pattern)]))
        return kinds

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline accounting; uses the
        padded vocab — that is what the hardware allocates and computes)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        mlp_mats = 3 if self.mlp_gated else 2
        total = v * d                      # embeddings
        if not self.tie_embeddings:
            total += v * d
        for mixer, ffn in self.layer_kinds():
            if mixer in (ATTN, ATTN_LOCAL, CROSS):
                total += d * (n_q + 2 * n_kv) + n_q * d
                if mixer == CROSS:         # extra cross-attention block
                    total += d * (n_q + 2 * n_kv) + n_q * d
            elif mixer == MAMBA:
                di, ns = self.d_inner, self.ssm_state
                dtr = self.resolved_dt_rank
                total += d * 2 * di                      # in_proj
                total += self.ssm_conv * di + di         # conv_w, conv_b
                total += di * (dtr + 2 * ns)             # x_proj
                total += dtr * di + di                   # dt_proj, dt_bias
                total += di * ns + di                    # A_log, D
                total += di * d                          # out_proj
            if ffn == MLP:
                total += mlp_mats * d * f
            elif ffn == MOE:
                total += d * self.n_experts              # router
                total += self.n_experts * 3 * d * f
            total += d                                   # norm1
            if ffn in (MLP, MOE):
                total += d                               # norm2
        total += d                                       # final norm
        if self.encoder_layers:
            per = (d * (n_q + 2 * n_kv) + n_q * d + mlp_mats * d * f
                   + 2 * d)
            total += self.encoder_layers * per
            # decoder cross-attention blocks
            total += self.n_layers * (d * (n_q + 2 * n_kv) + n_q * d + d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive_experts = self.n_experts - self.top_k
        n_moe_layers = sum(1 for _, ffn in self.layer_kinds() if ffn == MOE)
        return self.param_count() - n_moe_layers * inactive_experts * 3 * d * f
