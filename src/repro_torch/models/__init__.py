"""Model zoo, serving subset: dense attention stacks (phi3-mini-3.8b)."""
from repro_torch.models.transformer import (  # noqa: F401
    apply_stack,
    decode_step,
    init_decode_states,
    init_params,
)
