"""e4m3 block quantization (plain PyTorch versions)."""
