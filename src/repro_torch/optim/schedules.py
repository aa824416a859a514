"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

A schedule maps the (python int) step to the learning rate as a python
float. The arithmetic is done in float32 on the host, as the reference
does it in f32 on the device, so both packages step with the same lr;
``warmup_cosine`` reaches exactly 0 at ``total_steps``.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant_schedule(lr: float):
    def schedule(step):
        return float(_f32(lr))

    return schedule


def cosine_decay_schedule(init_lr: float, total_steps: int,
                          final_scale: float = 0.0):
    """Cosine from init_lr to final_scale * init_lr over total_steps."""

    def schedule(step):
        t = np.minimum(_f32(step), _f32(total_steps)) / _f32(
            max(total_steps, 1))
        cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * t))
        return float(_f32(init_lr) * (_f32(final_scale)
                                      + _f32(1.0 - final_scale) * cos))

    return schedule


def warmup_cosine_schedule(init_lr: float, total_steps: int,
                           warmup_steps: int = 0, final_scale: float = 0.0):
    cosine = cosine_decay_schedule(init_lr, max(total_steps - warmup_steps, 1),
                                   final_scale)

    def schedule(step):
        if step < warmup_steps:
            return float(_f32(init_lr) * _f32(step)
                         / _f32(max(warmup_steps, 1)))
        return cosine(step - warmup_steps)

    return schedule
