"""falcon-mamba-7b: 64L d_model=4096, attention-free mamba1 blocks (no FFN),
ssm_state=16, vocab=65024 [arXiv:2410.05355; unverified]. Same values as
``repro.configs.falcon_mamba_7b``."""

import dataclasses

from repro_torch.models.config import MAMBA, NONE, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    vocab=65024,
    d_model=4096,
    n_layers=64,
    d_ff=0,
    n_heads=0,
    n_kv_heads=0,
    layer_pattern=(MAMBA,),
    ffn_pattern=(NONE,),
    ssm_state=16,
    ssm_expand=2,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=4, ssm_state=4)
