"""Data pipeline of the port (counterpart of ``repro/data``)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

__all__ = ["DataConfig", "SyntheticLMDataset"]
