"""Training-side entry points of the port (twin of :mod:`repro.train`):
the objective and gradient accumulation, the trainer (host loop with
checkpoints, NaN rollback and preemption flush, and the fused segment),
checkpoints in the reference's format, and int8 error-feedback gradient
compression."""
from . import checkpoint
from .objective import grad_accum_step, lm_loss
from .trainer import TrainConfig, Trainer

__all__ = ["Trainer", "TrainConfig", "lm_loss", "grad_accum_step",
           "checkpoint"]
