"""jamba-1.5-large-398b: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2 — Mamba:attention 7:1 interleave (attention
at offset 4 of each 8-layer period), MoE every other layer
[arXiv:2403.19887; hf]. Same values as
``repro.configs.jamba_1_5_large_398b``."""

import dataclasses

from repro_torch.models.config import ATTN, MAMBA, MLP, MOE, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    vocab=65536,
    d_model=8192,
    n_layers=72,
    d_ff=24576,
    n_heads=64,
    n_kv_heads=8,
    layer_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    ffn_pattern=(MLP, MOE),
    n_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_expand=2,
    rope_theta=10_000.0,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=8, d_ff=128,
        n_heads=4, n_kv_heads=2, n_experts=4, top_k=2, ssm_state=4)
