"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

arXiv:2306.05284. The EnCodec frontend is a stub: conditioning is
modeled as 64 precomputed frame embeddings prepended to the audio-token
sequence (the real model uses text-conditioning cross-attention; see
DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    activation="gelu",
    rope_theta=10000.0,
    frontend="audio_stub",
    frontend_prefix_len=64,
)
