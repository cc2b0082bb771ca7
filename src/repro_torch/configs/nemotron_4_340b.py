"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU MLP.

arXiv:2402.16819 (config tier: unverified).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10000.0,
)
