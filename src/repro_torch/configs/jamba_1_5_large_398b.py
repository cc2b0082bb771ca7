"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave,
MoE 16 experts top-2. arXiv:2403.19887.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    activation="swiglu",
    rope_theta=10000.0,
    attn_every=8,          # 1 attention layer per 8 (1:7 with mamba)
    ssm_type="mamba",
    ssm_state_dim=16,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
    moe_every=2,           # MoE on every other layer (dense between)
)
