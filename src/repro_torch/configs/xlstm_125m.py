"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks, no FFN (d_ff=0).

arXiv:2405.04517 (config tier: unverified).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_type="xlstm",
)
