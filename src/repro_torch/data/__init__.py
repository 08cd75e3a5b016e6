from repro_torch.data.pipeline import (
    MemmapTokens,
    SyntheticLM,
    batch_iterator,
    modality_stub,
)

__all__ = ["SyntheticLM", "MemmapTokens", "batch_iterator", "modality_stub"]
