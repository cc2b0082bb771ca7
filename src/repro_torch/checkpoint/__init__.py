"""Fault-tolerant checkpoints with QLC-compressed byte-width leaves, one
directory of whole leaves for any layout of ranks."""
from repro_torch.checkpoint.manager import CheckpointManager, Layout  # noqa: F401
