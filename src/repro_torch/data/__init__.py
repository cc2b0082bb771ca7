"""Deterministic synthetic token data (numpy, as in the reference)."""
from repro_torch.data.synthetic import DataConfig, SyntheticDataset  # noqa: F401
