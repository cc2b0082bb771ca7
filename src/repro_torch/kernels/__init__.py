"""Fused codec kernels: CUDA for the card, plain versions for the CPU.
Use the entry points in ``repro_torch.kernels.ops``."""
