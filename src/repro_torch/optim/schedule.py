"""LR schedules as step -> lr callables.

The counterpart of ``repro/optim/schedule.py``: each value is computed
in float32 op by op as the reference computes it (the step as float32,
``max(1, warmup)``, the clip, ``cos(pi * prog)``), so the two agree to
an ulp with the reference run op by op. A step is an int or a 0-d
tensor; the lr is a 0-d float32 tensor on the step's device (the CPU
for an int).
"""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def f(step):
        s = _step_f32(step)
        return peak * torch.clamp_max(s / max(1, warmup_steps), 1.0)

    return f


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1):
    def f(step):
        s = _step_f32(step)
        warm = torch.clamp_max(s / max(1, warmup_steps), 1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        # the cosine of the float32 argument correctly rounded (through
        # float64), as XLA's is; torch.cos in float32 is 1 ulp off at
        # some steps, and 1 + cos near -1 magnifies that
        cos_ = torch.cos((math.pi * prog).double()).float()
        cos = floor + (1 - floor) * 0.5 * (1 + cos_)
        return peak * warm * cos

    return f
