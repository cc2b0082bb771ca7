"""chatglm3-6b [dense] — RoPE 2d (half-dim rotary), GQA kv=2.

arXiv:2406.12793.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    activation="swiglu",
    rope_fraction=0.5,   # GLM applies rotary to half the head dims
    rope_theta=10000.0,
)
