"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed top-6
experts of width 1408. arXiv:2401.06066.

Simplification vs the HF checkpoint: the real model's first layer is a
dense FFN; we use MoE on every layer (noted in DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    activation="swiglu",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2),
)
