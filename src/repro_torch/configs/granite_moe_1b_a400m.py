"""granite-moe-1b-a400m: 24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155,
MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]. Same
values as ``repro.configs.granite_moe_1b_a400m``."""

import dataclasses

from repro_torch.models.config import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    vocab=49155,
    d_model=1024,
    n_layers=24,
    d_ff=512,
    n_heads=16,
    n_kv_heads=8,
    layer_pattern=(ATTN,),
    ffn_pattern=(MOE,),
    n_experts=32,
    top_k=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=4, d_ff=64,
        n_heads=4, n_kv_heads=2, n_experts=8, top_k=2)
