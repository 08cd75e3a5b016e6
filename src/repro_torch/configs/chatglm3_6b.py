"""chatglm3-6b: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 —
partial (2d) rotary on half the head dims [arXiv:2406.12793; hf]. Same
values as ``repro.configs.chatglm3_6b``."""

import dataclasses

from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    vocab=65024,
    d_model=4096,
    n_layers=28,
    d_ff=13696,
    n_heads=32,
    n_kv_heads=2,
    layer_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    partial_rotary=0.5,
    rope_theta=10_000.0,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=4, d_ff=128,
        n_heads=4, n_kv_heads=2)
