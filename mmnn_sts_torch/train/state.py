"""Training state (counterpart of the JAX package's train/state.py).

The JAX package keeps everything mutable in one immutable pytree. Here the
model (parameters and BatchNorm buffers) and the optimizer (momentum
buffers) are updated in place, and ``TrainState`` holds them with the
schedule, the step and epoch counters, the gradient-blending state and the
dropout generator, on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.blending import BlendState, blend_init
from .schedule import Schedule


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    blend: BlendState
    generator: torch.Generator
    step: int = 0
    epoch: int = 0

    def apply_gradients(self):
        """One optimizer step on the gradients in ``.grad`` at the
        schedule's learning rate for this step; ``step += 1``."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       schedule: Schedule, seed: int = 42,
                       num_blend_heads: int = 3) -> TrainState:
    """A fresh state around ``model`` (its parameters already initialised
    or loaded) and ``optimizer`` over them, with uniform blend weights and
    a dropout generator seeded with ``seed`` on the model's device."""
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=optimizer,
        schedule=schedule,
        blend=blend_init(num_blend_heads, device),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
