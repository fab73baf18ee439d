"""Piecewise-constant parameter schedules; counterpart of the JAX package's
`training/schedules.py`.

The base value is multiplied by vals[i], where i is the number of
boundaries the step counter has reached. The step is a host integer here,
so a schedule costs no device work and no synchronisation; the product is
rounded to float32 as the JAX package's traced product is.
"""

import numpy as np

from hific_tpu_torch.config import Schedule


def scheduled_param(base: float, schedule: Schedule, step: int,
                    ignore_schedule: bool = False) -> float:
    if ignore_schedule or len(schedule.steps) == 0:
        if len(schedule.vals) > 0 and not ignore_schedule:
            return base * schedule.vals[0]
        return base
    idx = sum(step >= boundary for boundary in schedule.steps)
    return float(np.float32(base) * np.float32(schedule.vals[idx]))
