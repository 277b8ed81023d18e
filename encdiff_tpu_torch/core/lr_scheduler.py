"""The LR schedule of every EncDiff LDM config.

A copy of ``LambdaLinearScheduler`` (``encdiff_tpu/core/lr_scheduler.py:41-98``,
linear warmup then linear decay over each cycle) and of the single-cycle
linear branch of ``as_optax_schedule`` (:101-120), which turns one into
``lr(count)``. The JAX train step keys the schedule on the optimizer's own
update count, which starts at 0 with a fresh optimizer, not on the global
step; the train loop here sets each step's LR from that count itself.
``as_lr_schedule`` computes in float32 in the order the JAX expression
does, so both give the same bits.
"""

from __future__ import annotations

import numpy as np


class LambdaLinearScheduler:
    """``f(n)``: the LR multiplier at update ``n`` (``lr_scheduler.py:36-98``)."""

    def __init__(self, warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                 verbosity_interval=0):
        assert (len(warm_up_steps) == len(f_min) == len(f_max)
                == len(f_start) == len(cycle_lengths))
        self.lr_warm_up_steps = list(warm_up_steps)
        self.f_start = list(f_start)
        self.f_min = list(f_min)
        self.f_max = list(f_max)
        self.cycle_lengths = list(cycle_lengths)
        self.cum_cycles = np.cumsum([0] + list(self.cycle_lengths))
        del verbosity_interval

    def find_in_interval(self, n):
        interval = 0
        for cl in self.cum_cycles[1:]:
            if n <= cl:
                return interval
            interval += 1
        return max(len(self.cycle_lengths) - 1, 0)

    def __call__(self, n):
        cycle = self.find_in_interval(n)
        n = n - self.cum_cycles[cycle]
        if n < self.lr_warm_up_steps[cycle]:
            return ((self.f_max[cycle] - self.f_start[cycle])
                    / self.lr_warm_up_steps[cycle] * n + self.f_start[cycle])
        return self.f_min[cycle] + (self.f_max[cycle] - self.f_min[cycle]) * (
            self.cycle_lengths[cycle] - n) / self.cycle_lengths[cycle]


def as_lr_schedule(sched: LambdaLinearScheduler, base_lr: float):
    """``lr(count)`` for a single-cycle ``LambdaLinearScheduler`` (the
    flagship's: warmup 10k from f_start 1e-6, cycle 1e13)."""
    if len(sched.cycle_lengths) != 1:
        raise NotImplementedError("only a single-cycle schedule is ported")
    f32 = np.float32
    warm = float(sched.lr_warm_up_steps[0])
    f_start, f_max, f_min = (float(sched.f_start[0]), float(sched.f_max[0]),
                             float(sched.f_min[0]))
    cycle = float(sched.cycle_lengths[0])

    def schedule(count: int) -> float:
        step = f32(count)
        warm_f = f32((f_max - f_start) / warm) * step + f32(f_start)
        decay_f = f32(f_min) + f32(f_max - f_min) * (f32(cycle) - step) / f32(cycle)
        return float(f32(base_lr) * (warm_f if step < f32(warm) else decay_f))

    return schedule
