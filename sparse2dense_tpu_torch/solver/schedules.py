"""One-cycle learning-rate and momentum schedules as functions of the step
(counterpart of ``sparse2dense_tpu/solver/schedules.py``): the learning
rate anneals on a cosine from lr_max / div_factor up to lr_max over
``pct_start`` of training, then down to lr_max / div_factor / 1e4; the
momentum anneals from moms[0] to moms[1] and back. Values are float32, as
the reference computes them."""
from __future__ import annotations

import numpy as np

_F32 = np.float32


def annealing_cos(start, end, pct):
    cos_out = np.cos(_F32(np.pi) * _F32(pct)) + _F32(1.0)
    return _F32(end) + (_F32(start) - _F32(end)) / _F32(2.0) * cos_out


def one_cycle_lr(lr_max: float, div_factor: float, pct_start: float, total_steps: int):
    low_lr = lr_max / div_factor
    split = int(total_steps * pct_start)

    def schedule(step: int) -> np.float32:
        step = _F32(step)
        if step < split:
            return annealing_cos(low_lr, lr_max, step / _F32(max(split, 1)))
        return annealing_cos(lr_max, low_lr / 1e4,
                             (step - _F32(split)) / _F32(max(total_steps - split, 1)))

    return schedule


def one_cycle_momentum(moms, pct_start: float, total_steps: int):
    m0, m1 = moms
    split = int(total_steps * pct_start)

    def schedule(step: int) -> np.float32:
        step = _F32(step)
        if step < split:
            return annealing_cos(m0, m1, step / _F32(max(split, 1)))
        return annealing_cos(m1, m0, (step - _F32(split)) / _F32(max(total_steps - split, 1)))

    return schedule
