"""The port's optimizer and schedules (twin of :mod:`repro.optim`)."""
from .adam import AdamState, AdamW, global_norm
from .schedule import constant, cosine_with_warmup

__all__ = ["AdamW", "AdamState", "global_norm", "cosine_with_warmup",
           "constant"]
