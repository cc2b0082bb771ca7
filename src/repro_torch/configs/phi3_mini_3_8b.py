"""phi3-mini-3.8b [dense] — RoPE, SwiGLU, kv=32 (full MHA).

arXiv:2404.14219 (config tier: unverified).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    rope_theta=10000.0,
)
