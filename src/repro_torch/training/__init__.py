"""Training: optimizer, baseline and compressed train steps, trainer."""
from repro_torch.training.optimizer import OptConfig  # noqa: F401
from repro_torch.training.train_step import (  # noqa: F401
    TrainConfig,
    init_compressed_opt_state,
    make_baseline_step,
    make_compressed_step,
    make_zero1_fallback,
    step_channels,
)
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: F401
