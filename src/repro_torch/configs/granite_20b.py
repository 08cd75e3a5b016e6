"""granite-20b: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 —
llama-arch code model [arXiv:2405.04324; hf]. Same values as
``repro.configs.granite_20b``."""

import dataclasses

from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    vocab=49152,
    d_model=6144,
    n_layers=52,
    d_ff=24576,
    n_heads=48,
    n_kv_heads=1,
    layer_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    rope_theta=10_000.0,
    tie_embeddings=False,
    mlp_gated=False,   # GPT-BigCode-style classic 2-matrix MLP
    act="gelu",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=4, d_ff=192,
        n_heads=4, n_kv_heads=1)
