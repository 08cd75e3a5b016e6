"""seamless-m4t-medium: enc-dec, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206 — realised as 12 encoder layers + 12 decoder layers (each
decoder layer = self-attn + cross-attn + FFN, encoded as a 2-entry pattern
period, so n_layers=24 pattern entries = 12 logical decoder layers). The
speech frontend is a STUB: the serving launcher provides precomputed frame
embeddings (``repro_torch.data.modality_stub``) [arXiv:2308.11596; hf].
Same values as ``repro.configs.seamless_m4t_medium``."""

import dataclasses

from repro_torch.models.config import ATTN, CROSS, MLP, NONE, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    vocab=256206,
    d_model=1024,
    n_layers=24,                       # (attn, cross) x 12 logical layers
    d_ff=4096,
    n_heads=16,
    n_kv_heads=16,
    layer_pattern=(ATTN, CROSS),
    ffn_pattern=(NONE, MLP),
    encoder_layers=12,
    encoder_frames=1024,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, vocab=512, d_model=64, n_layers=4, d_ff=128,
        n_heads=4, n_kv_heads=4, encoder_layers=2, encoder_frames=16)
