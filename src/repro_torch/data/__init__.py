from repro_torch.data.pipeline import SyntheticLM, modality_stub

__all__ = ["SyntheticLM", "modality_stub"]
