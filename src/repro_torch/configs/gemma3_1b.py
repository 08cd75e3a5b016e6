"""gemma3-1b: 26L d_model=1152 4H (GQA kv=1, head_dim=256) d_ff=6912
vocab=262144 — 5:1 local(sw=512):global interleave, dual RoPE theta
[hf:google/gemma-3-1b-pt; unverified]. Same values as
``repro.configs.gemma3_1b``."""

import dataclasses

from repro_torch.models.config import ATTN, ATTN_LOCAL, MLP, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    vocab=262144,
    d_model=1152,
    n_layers=26,
    d_ff=6912,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    layer_pattern=(ATTN_LOCAL,) * 5 + (ATTN,),
    ffn_pattern=(MLP,),
    sliding_window=512,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=8, d_ff=128,
        n_heads=4, n_kv_heads=1, head_dim=16, sliding_window=8)
