"""The paper's own experimental setting (§3): Gemma-2B during SFT —
18 layers, sharded over 64 TPUs, FFN1/FFN2 tensors analyzed at e4m3.

arXiv:2403.08295 (Gemma 2B: 18L, d_model 2048, 8H MQA kv=1, d_ff 16384
GeGLU, vocab 256128).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b-sft",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256128,
    activation="swiglu",   # GeGLU-family gated MLP
    rope_theta=10000.0,
)
