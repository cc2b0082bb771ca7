"""Model zoo subset, for serving (decode) and training (full-sequence
forward and loss): dense and MoE attention stacks (phi3-mini-3.8b,
deepseek-moe-16b), the recurrent xLSTM and hybrid mamba stacks
(xlstm-125m, jamba's blocks; ``models.ssm``), and the modality stubs
(``models.multimodal``) that make a vlm or audio config's prefix
embeddings."""
from repro_torch.models.transformer import (  # noqa: F401
    apply_stack,
    decode_step,
    forward,
    init_decode_states,
    init_params,
    next_token_loss,
)
