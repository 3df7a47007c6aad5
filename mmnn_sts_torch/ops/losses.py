"""Classification losses (counterpart of the JAX package's ops/losses.py).

* ``bce_with_logits``: sigmoid BCE with a per-class ``pos_weight`` (the
  reference's ``torch.nn.BCEWithLogitsLoss``), reduced by ``sum`` (train),
  ``mean`` or ``none`` (validation), with an optional per-sample mask for a
  wrap-padded ragged batch. It is computed in the JAX package's softplus
  form: ``binary_cross_entropy_with_logits`` computes a small loss of a
  negative logit as a difference of two large terms, 4e-4 off relative.
* ``pos_weight_from_frequencies``: ``(1 - f) / f`` per class.
* ``focal_binary_cross_entropy`` and ``multilabel_bce`` operate on
  probabilities; the JAX package has them, though no loop uses them.
"""

from __future__ import annotations

import torch

from ..constants import NUM_CLASSES


def bce_with_logits(logits, targets, pos_weight=None, reduction: str = "sum",
                    mask=None):
    """``-[pw * y * log(sigmoid(x)) + (1 - y) * log(1 - sigmoid(x))]`` in
    float32 (losses.py:21-58). ``mask`` (N,): masked samples contribute
    zero, so the masked sum is the loss of the valid samples alone."""
    x = logits.float()
    y = targets.float()
    # log(sigmoid(x)) = -softplus(-x); log(1 - sigmoid(x)) = -softplus(x)
    pos = y * _softplus(-x)
    if pos_weight is not None:
        pos = torch.as_tensor(pos_weight, dtype=torch.float32,
                              device=x.device) * pos
    loss = pos + (1.0 - y) * _softplus(x)
    if mask is not None:
        loss = loss * mask.float().view((loss.shape[0],)
                                        + (1,) * (loss.dim() - 1))
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    if reduction in ("none", None):
        return loss
    raise ValueError(f"Unrecognized reduction: {reduction}")


def _softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def pos_weight_from_frequencies(class_freqs) -> torch.Tensor:
    """pos_weight = (1 - f) / f per class, float32."""
    f = torch.as_tensor(class_freqs, dtype=torch.float32)
    return (1.0 - f) / f


def focal_binary_cross_entropy(logits, targets, gamma: float = 2.0):
    """Focal BCE whose ``logits`` are probabilities, as in the reference's
    formula (losses.py:67-78)."""
    p = logits.reshape(-1).float()
    t = targets.reshape(-1).float()
    p = torch.where(t >= 0.5, p, 1.0 - p)
    logp = -torch.log(torch.clamp(p, 1e-4, 1.0 - 1e-4))
    return NUM_CLASSES * (logp * (1.0 - p) ** gamma).mean()


def multilabel_bce(probs, targets, reduction: str = "mean"):
    """BCE on probabilities clipped to [1e-7, 1 - 1e-7] (losses.py:81-92)."""
    p = targets.float()
    q = torch.clamp(probs.float(), 1e-7, 1.0 - 1e-7)
    loss = -(p * torch.log(q) + (1.0 - p) * torch.log(1.0 - q))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
