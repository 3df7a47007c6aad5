"""Learning-rate schedule + optimizer (counterpart of the JAX package's
train/schedule.py).

* ``onecycle``: optax's ``cosine_onecycle_schedule`` (pct_start 0.3,
  div_factor 25, final_div_factor 1e4) as a plain function of the step, in
  float32 as optax computes it, with the JAX package's guard of at least 4
  total steps (schedule.py:17-29). torch's ``OneCycleLR`` puts its phase
  boundaries elsewhere, so it is not used.
* ``make_optimizer``: SGD with nesterov momentum 0.9 and weight decay 1e-4
  added to the gradient before the momentum, as ``optax.add_decayed_weights``
  + ``optax.sgd(nesterov=True)`` do; the caller sets each step's learning
  rate from the schedule (``TrainState.begin_step`` and
  ``device_update``, which read it from a device table).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

Schedule = Callable[[int], float]


def onecycle(lr: float, steps_per_epoch: int, epochs: int) -> Schedule:
    """The learning rate of optimizer step ``step`` (0-based): a cosine
    rise from lr / 25 to lr over the first int(0.3 * total) steps, a cosine
    fall to lr / 25e4 at ``total``, flat after it."""
    total = max(steps_per_epoch * epochs, 4)
    bounds = np.array([0, int(0.3 * total), total])
    values = np.cumprod([lr / 25.0, 25.0, 1.0 / (25.0 * 1e4)])
    sizes = (bounds[1:] - bounds[:-1]).astype(np.float32)
    start, end = values[:-1], values[1:]
    half = ((start - end) / 2.0).astype(np.float32)
    end32 = end.astype(np.float32)

    def schedule(step: int) -> float:
        inside = (bounds[:-1] <= step) & (step < bounds[1:])
        pct = np.float32(step - bounds[:-1]) / sizes
        interp = end32 + half * (np.cos(np.float32(np.pi) * pct)
                                 + np.float32(1.0))
        after = np.float32(values[-1]) if bounds[-1] <= step else np.float32(0)
        return float(np.sum(np.where(inside, interp, np.float32(0)),
                            dtype=np.float32) + after)

    return schedule


def steps_per_epoch(num_samples: int, step_batch: int) -> int:
    """Optimizer steps per epoch: ceil(num_samples / step_batch)."""
    return -(-num_samples // step_batch)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   steps_per_epoch_: int, epochs: int, momentum: float = 0.9,
                   weight_decay: float = 1e-4
                   ) -> tuple[torch.optim.SGD, Schedule]:
    """SGD-nesterov with the weight decay added to the gradient (torch's
    rule and optax's), and its OneCycle schedule."""
    schedule = onecycle(lr, steps_per_epoch_, epochs)
    opt = torch.optim.SGD(params, lr=schedule(0), momentum=momentum,
                          nesterov=True, weight_decay=weight_decay)
    return opt, schedule
