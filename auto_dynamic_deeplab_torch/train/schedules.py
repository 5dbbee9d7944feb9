"""Per-iteration learning-rate schedules (train/schedules.py of the JAX
package; the reference's utils/lr_scheduler.py LR_Scheduler) as pure
``step -> lr`` functions. The update at optimizer count k (from 0) uses
lr(k), as optax's schedules do: ``train.step.TrainStep`` sets it on the
optimizer's param groups before each ``step()``."""
from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def lr_schedule(
    mode: str,
    base_lr: float,
    num_epochs: int,
    iters_per_epoch: int,
    lr_step: int = 0,
    warmup_epochs: int = 0,
    min_lr: Optional[float] = None,
) -> Schedule:
    """Modes (lr_scheduler.py:44-76), T the step and N the steps in all:
      cos:  lr * ((1 - min_lr) * 0.5 (1 + cos(pi T/N)) + min_lr)
      poly: lr * (1 - T/N)^0.9
      step: lr * 0.1^(epoch // lr_step)
    then the reference's min_lr floor and a linear warmup.
    """
    N = float(num_epochs * iters_per_epoch)
    warmup_iters = float(warmup_epochs * iters_per_epoch)
    if mode not in ("cos", "poly", "step"):
        raise NotImplementedError(mode)
    if mode == "step" and not lr_step:
        raise ValueError("step mode needs lr_step")
    if mode == "cos" and min_lr is None:
        raise ValueError("the reference's cos mode needs min_lr")

    def schedule(step: int) -> float:
        T = float(step)
        if mode == "cos":
            lr = base_lr * ((1.0 - min_lr) * 0.5 * (1.0 + math.cos(T / N * math.pi)) + min_lr)
        elif mode == "poly":
            lr = base_lr * max(1.0 - T / N, 0.0) ** 0.9
        else:
            lr = base_lr * 0.1 ** math.floor(math.floor(T / iters_per_epoch) / lr_step)
        if min_lr is not None:
            lr = max(lr, min_lr)
        if warmup_iters > 0 and T < warmup_iters:
            lr = lr * T / warmup_iters
        return lr

    return schedule
