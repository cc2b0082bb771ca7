"""The roofline on H100 terms: the card's peaks (``hw``), the counted
work of a step (``op_count``), the three-term bound and the model-FLOP
share (``analysis``), and the profiled step on the card (``trace``)."""
from repro_torch.roofline.op_count import (  # noqa: F401
    KERNEL_OF,
    OpRecord,
    count,
    kernel_bytes,
)
