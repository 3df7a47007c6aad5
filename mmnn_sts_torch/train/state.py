"""Training state (counterpart of the JAX package's train/state.py).

The JAX package keeps everything mutable in one immutable pytree. Here the
model (parameters and BatchNorm buffers) and the optimizer (momentum
buffers) are updated in place, and ``TrainState`` holds them with the
schedule, the step and epoch counters, the gradient-blending state and the
dropout generator, on the model's device.

Everything a step reads or writes on the device lives at a fixed address,
so that a CUDA graph of the step (``train/graphs.py``, ``TPU.fused_epoch``)
can replay it:

* the gradients: allocated once (``gradients``), zeroed in place before
  each step, accumulated into by every backward;
* the momentum buffers: the optimizer's ``state[p]["momentum_buffer"]``,
  made (zeros) before the first update, so ``optimizer.state_dict()`` keeps
  torch's layout;
* the learning rate: the schedule's float32 values in a device table
  (``rates``), read at a device step counter (``step_t``). ``step`` stays
  on the host for checkpoints; ``begin_step`` copies it to the counter
  before each step.

``device_update`` is torch's SGD (nesterov momentum, weight decay added to
the gradient, dampening) as foreach ops with the rate as a device tensor:
the same operations as ``torch.optim.SGD``'s, the last one an ``addcmul``
with the rate where torch adds with ``alpha=-lr`` (torch's own SGD takes a
tensor rate through ``.item()``, which a graph cannot hold).
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
    # the schedule's rates for steps [0, len) and the device step counter
    rates: torch.Tensor | None = None
    step_t: torch.Tensor | None = None
    # train/graphs' bound step bodies (EpochSteps, BoundBody), by key
    graphs: dict = field(default_factory=dict, repr=False)
    # the ranks' mesh (parallel/mesh.Mesh); None: one process
    mesh: object = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def trainable(self) -> list[nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.requires_grad]

    def gradients(self) -> list[torch.Tensor]:
        """Each trainable parameter's ``.grad``, made (zeros) where it is
        missing. optax decays and carries momentum for every parameter, so
        a parameter no loss reaches keeps a zero gradient."""
        for p in self.trainable():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.trainable()]

    def zero_gradients(self):
        torch._foreach_zero_(self.gradients())

    def momentum_buffers(self) -> list[torch.Tensor]:
        """Each trainable parameter's momentum buffer, made (zeros) where it
        is missing: the first update then gives ``buf = g`` as torch's and
        optax's do."""
        state = self.optimizer.state
        for p in self.trainable():
            if state[p].get("momentum_buffer") is None:
                state[p]["momentum_buffer"] = torch.zeros_like(p)
        return [state[p]["momentum_buffer"] for p in self.trainable()]

    def ensure_rates(self, steps: int):
        """The rate table covers steps [0, ``steps``): rebuilt (at least
        doubled) from the schedule when it does not."""
        have = 0 if self.rates is None else self.rates.numel()
        if have >= steps:
            return
        n = max(steps, 2 * have, 1)
        self.rates = torch.tensor([self.schedule(s) for s in range(n)],
                                  dtype=torch.float32).to(self.device)

    def begin_step(self):
        """Before a step: the rate table covers it and the device counter
        holds ``step``."""
        self.ensure_rates(self.step + 1)
        if self.step_t is None:
            self.step_t = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self.step_t.fill_(self.step)

    @torch.no_grad()
    def device_update(self):
        """One SGD update from the gradients in ``.grad`` at the rate of
        the device step counter, which then counts one on. Only device
        work: ``step`` is the caller's."""
        (group,) = self.optimizer.param_groups
        params, grads = self.trainable(), self.gradients()
        bufs = self.momentum_buffers()
        momentum, wd = group["momentum"], group["weight_decay"]
        if wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, grads, alpha=1 - group["dampening"])
        if group["nesterov"]:
            grads = torch._foreach_add(grads, bufs, alpha=momentum)
        else:
            grads = bufs
        # index_select, not rates[step_t]: a 0-dim index is read on the host
        neg_rate = -self.rates.index_select(0, self.step_t.view(1))[0]
        torch._foreach_addcmul_(params, grads, [neg_rate] * len(params))
        self.step_t += 1


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       schedule: Schedule, seed: int = 42,
                       num_blend_heads: int = 3, mesh=None) -> TrainState:
    """A fresh state around ``model`` (its parameters already initialised
    or loaded) and ``optimizer`` over them, with uniform blend weights and
    a dropout generator seeded with ``seed`` on the model's device. Under
    a ``mesh`` of ranks every rank builds the same state from the same
    seed; the steps shard over its ``data`` axis."""
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=optimizer,
        schedule=schedule,
        blend=blend_init(num_blend_heads, device),
        generator=torch.Generator(device=device).manual_seed(seed),
        mesh=mesh,
    )
