"""Optimizers and LR schedules of the LM substrate (the counterpart of
``repro/optim``)."""
from .adamw import AdamW, global_norm, quantize_int8, sgd_momentum
from .schedule import cosine_schedule, linear_warmup

__all__ = ["AdamW", "global_norm", "quantize_int8", "sgd_momentum",
           "cosine_schedule", "linear_warmup"]
