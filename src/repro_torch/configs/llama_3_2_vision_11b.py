"""llama-3.2-vision-11b: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attention image layers every 5th layer (global
indices 3, 8, 13, ...). The vision frontend is a STUB: the serving
launcher provides precomputed patch embeddings (4 tiles x 1601 patches,
``repro_torch.data.modality_stub``) [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]. Same values as ``repro.configs.llama_3_2_vision_11b``."""

import dataclasses

from repro_torch.models.config import ATTN, CROSS, MLP, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    vocab=128256,
    d_model=4096,
    n_layers=40,
    d_ff=14336,
    n_heads=32,
    n_kv_heads=8,
    layer_pattern=(ATTN, ATTN, ATTN, CROSS, ATTN),
    ffn_pattern=(MLP,),
    image_tokens=6404,
    rope_theta=500_000.0,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=5, d_ff=128,
        n_heads=4, n_kv_heads=2, image_tokens=8)
