"""The model zoo, for serving (decode) and training (full-sequence
forward and loss): dense and MoE attention stacks with swiglu, gelu or
squared-ReLU FFNs, sliding-window attention and padded heads, the
recurrent xLSTM and hybrid mamba stacks (``models.ssm``), and the
modality stubs (``models.multimodal``) that make a vlm or audio config's
prefix embeddings."""
from repro_torch.models.transformer import (  # noqa: F401
    apply_stack,
    decode_step,
    forward,
    init_decode_states,
    init_params,
    next_token_loss,
    prefill_logits,
)
