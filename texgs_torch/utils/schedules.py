"""Learning-rate schedules (port of texgs/utils/schedules.py).

expon_lr: log-linear decay with an optional sin-eased delay.
warmup_multistep: a linear warm-up (0.01 -> 1 over 100 steps) chained with
multi-step decay, the UV nets' schedule.  Both are host-side callables of
the step number.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def expon_lr(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000,
             ) -> Callable[[int], float]:
    def helper(step: int) -> float:
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper


def warmup_multistep(base_lr: float, milestones: Sequence[int], gamma: float,
                     warmup_iters: int = 100, start_factor: float = 0.01,
                     ) -> Callable[[int], float]:
    """At optimizer step k (0-based) the factor is that of scheduler epoch
    k, as for torch schedulers stepped once after each optimizer step."""
    milestones = sorted(milestones)

    def helper(step: int) -> float:
        if step < warmup_iters:
            warm = start_factor + (1.0 - start_factor) * (step / warmup_iters)
        else:
            warm = 1.0
        decay = gamma ** sum(1 for m in milestones if step >= m)
        return base_lr * warm * decay

    return helper
