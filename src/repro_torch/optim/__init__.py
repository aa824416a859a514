from repro_torch.optim.optimizers import (
    Optimizer,
    OptimizerConfig,
    adamw,
    make_optimizer,
    sgd_momentum,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_decay_schedule,
    warmup_cosine_schedule,
)

__all__ = [
    "Optimizer",
    "OptimizerConfig",
    "adamw",
    "constant_schedule",
    "cosine_decay_schedule",
    "make_optimizer",
    "sgd_momentum",
    "warmup_cosine_schedule",
]
