"""Plain reference of the survival training step and its schedule.

* The loss: the negative Cox partial log-likelihood of each target column
  (pycox's formulation, which MMNN_STS trains with): the batch sorted by
  duration, longest first, ties in input order (a stable sort), each
  event's log-hazard against the log of the cumulative hazard of the rows
  before it and itself (``log(cumsum(exp(h - max h)) + 1e-7) + max h``),
  summed over events and divided by their number; masked rows take part
  in no risk set and no event. The two targets' losses add up. With
  gradient blending the three heads' losses are weighted by the blend
  weights (uniform until the first update).
* The step: a super-batch of A microbatches of B, each augmented, run
  forward in train mode and back-propagated into summed gradients; then
  one SGD update with weight decay 1e-4 added to the gradient, Nesterov
  momentum 0.9, at the OneCycle rate of the step.
* OneCycle (optax's ``cosine_onecycle_schedule``, pct_start 0.3,
  div_factor 25, final_div_factor 1e4) over ``max(steps_per_epoch *
  epochs, 4)`` steps.
* The epoch's order: ``numpy.random.default_rng((seed, epoch))``'s
  permutation of the split, wrap-padded from its own start to whole
  super-batches; the pad rows (the last super-batch's, after the split's
  own) are masked: they take part in no loss and no BatchNorm statistic,
  but are augmented and drawn dropout for like the others.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import augment as aug

COX_EPS = 1e-7


def cox_loss(log_h, events, durations, mask=None):
    """(C,) loss of each column of (N, C) log-hazards."""
    order = torch.argsort(-durations, dim=0, stable=True)
    h = log_h.float().gather(0, order)
    ev = events.float().gather(0, order)
    if mask is None:
        valid = torch.ones_like(h, dtype=torch.bool)
    else:
        valid = mask.float()[:, None].expand_as(log_h).gather(0, order) > 0
    ev = ev * valid
    top = torch.where(valid, h, float("-inf")).amax(0)
    top = torch.where(torch.isfinite(top), top, 0.0).detach()
    h = torch.where(valid, h, top)
    w = torch.where(valid, torch.exp(h - top), 0.0)
    log_risk = torch.log(torch.cumsum(w, 0) + COX_EPS) + top
    return -((h - log_risk) * ev).sum(0) / torch.clamp(ev.sum(0), min=1.0)


def step_loss(out, events, durations, blend_weights, mask=None):
    """(loss to train on, the multimodal head's loss)."""
    if blend_weights is None:
        loss = cox_loss(out, events, durations, mask).sum()
        return loss, loss
    heads = torch.stack([cox_loss(o, events, durations, mask).sum()
                         for o in out])
    return (blend_weights * heads).sum(), heads[0]


def onecycle_rate(step: int, lr: float, steps_per_epoch: int,
                  epochs: int) -> float:
    total = max(steps_per_epoch * epochs, 4)
    rise = int(0.3 * total)
    start, peak, end = lr / 25.0, lr, lr / 25.0 / 1e4
    if step >= total:
        return end
    if step < rise:
        a, b, pct = start, peak, step / rise
    else:
        a, b, pct = peak, end, (step - rise) / (total - rise)
    return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def epoch_order(seed: int, n: int, accum: int, micro: int, epoch: int):
    """(steps, accum, micro) row indices of an epoch."""
    order = np.random.default_rng((seed, epoch)).permutation(n)
    per = accum * micro
    total = -(-n // per) * per
    if total > n:
        order = np.concatenate([order, np.resize(order, total - n)])
    return order.reshape(-1, accum, micro)


def pad_mask(n: int, accum: int, micro: int) -> np.ndarray:
    """(steps, accum, micro) 1 for a split's row, 0 for a pad row."""
    per = accum * micro
    total = -(-n // per) * per
    return (np.arange(total) < n).astype(np.float32).reshape(
        -1, accum, micro)


class Trainer:
    """The reference model with its SGD state."""

    def __init__(self, model, weights: dict, hp: dict, steps_per_epoch: int,
                 blend: bool):
        self.model = model
        self.model.load_state_dict(weights, strict=True)
        self.params = dict(self.model.named_parameters())
        self.momentum = {k: torch.zeros_like(p)
                         for k, p in self.params.items()}
        self.hp, self.spe, self.step = hp, steps_per_epoch, 0
        device = next(iter(self.params.values())).device
        self.blend = (torch.full((3,), 1.0 / 3.0, device=device)
                      if blend else None)

    def superstep(self, inputs, events, durations, generator, augment=True,
                  half_batch=False, mask=None):
        """One update over (A, B, ...) inputs, ``mask`` (A, B) marking
        the valid rows of a padded one; returns (summed loss, the
        predictions (A, [K,] B, C), the gradients as SGD takes them: with
        the weight decay added). ``half_batch`` takes the loss over the
        first half of every microbatch alone (a planted fault)."""
        self.model.train()
        for p in self.params.values():
            p.grad = None
        total, preds = 0.0, []
        image_key = "image" if isinstance(inputs, dict) else None
        b = events.shape[1] // 2 if half_batch else events.shape[1]
        for i in range(events.shape[0]):
            x = ({k: v[i] for k, v in inputs.items()} if image_key
                 else inputs[i])
            vols = x[image_key] if image_key else x
            if augment:
                drawn = aug.draw(vols.shape[0], tuple(vols.shape[1:]),
                                 generator, vols.device)
                vols = aug.augment(vols, drawn)
            else:
                vols = aug.eval_transform(vols)
            x = {**x, image_key: vols} if image_key else vols
            m = None if mask is None else mask[i]
            out = self.model(x, mask=m, generator=generator)
            loss, _ = step_loss(out[..., :b, :], events[i, :b],
                                durations[i, :b], self.blend,
                                None if m is None else m[:b])
            loss.backward()
            total += float(loss.detach())
            preds.append(out.detach())
        grads = self.update()
        return total, torch.stack(preds), grads

    @torch.no_grad()
    def update(self) -> dict:
        hp = self.hp
        rate = onecycle_rate(self.step, hp["learning_rate"], self.spe,
                             hp["epochs"])
        grads = {}
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g + hp["weight_decay"] * p
            grads[k] = g
            buf = self.momentum[k]
            buf.mul_(hp["momentum"]).add_(g)
            p.sub_(rate * (g + hp["momentum"] * buf))
        self.step += 1
        return grads

    @torch.no_grad()
    def evaluate(self, inputs, rows: int = 32):
        """Eval-mode predictions of a split, ``rows`` at a time."""
        self.model.eval()
        multi = isinstance(inputs, dict)
        n = (inputs["image"] if multi else inputs).shape[0]
        outs = []
        for s in range(0, n, rows):
            x = ({k: v[s:s + rows] for k, v in inputs.items()} if multi
                 else inputs[s:s + rows])
            if multi:
                x = {**x, "image": aug.eval_transform(x["image"])}
            else:
                x = aug.eval_transform(x)
            outs.append(self.model(x))
        return torch.cat(outs, dim=-2)
