"""granite-3-2b: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155 [hf:ibm-
granite/granite-3.0-2b-base; hf]. Same values as
``repro.configs.granite_3_2b``."""

import dataclasses

from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    vocab=49155,
    d_model=2048,
    n_layers=40,
    d_ff=8192,
    n_heads=32,
    n_kv_heads=8,
    layer_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=4, d_ff=128,
        n_heads=4, n_kv_heads=2)
