"""Fault-tolerant checkpoints with QLC-compressed byte-width leaves."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
