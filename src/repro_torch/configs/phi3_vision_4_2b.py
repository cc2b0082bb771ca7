"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUB.

hf:microsoft/Phi-3-vision-128k-instruct. The vision tower is a stub:
``input_specs()`` provides 576 precomputed patch embeddings (ViT-L/14 at
336px) prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    rope_theta=10000.0,
    frontend="vision_stub",
    frontend_prefix_len=576,
)
