"""mixtral-8x7b: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8
experts top-2, sliding-window 4096 attention [arXiv:2401.04088; hf]. Same
values as ``repro.configs.mixtral_8x7b``."""

import dataclasses

from repro_torch.models.config import ATTN_LOCAL, MOE, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    vocab=32000,
    d_model=4096,
    n_layers=32,
    d_ff=14336,
    n_heads=32,
    n_kv_heads=8,
    layer_pattern=(ATTN_LOCAL,),
    ffn_pattern=(MOE,),
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=4, d_ff=128,
        n_heads=4, n_kv_heads=2, sliding_window=8, n_experts=4, top_k=2)
