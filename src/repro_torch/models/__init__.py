"""Model zoo subset: dense attention stacks (phi3-mini-3.8b), for
serving (decode) and training (full-sequence forward and loss)."""
from repro_torch.models.transformer import (  # noqa: F401
    apply_stack,
    decode_step,
    forward,
    init_decode_states,
    init_params,
    next_token_loss,
)
