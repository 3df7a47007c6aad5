"""Deterministic image preprocessing (counterpart of the eval half of
the JAX package's ops/augment.py: ``normalize``, ``scale_intensity`` and
``eval_transform``, augment.py:60-70, 413-418). The random training
augmentation is not ported yet (ROADMAP.md, Queue 1).

Each function takes one volume; its max and min run over the whole tensor,
channels included, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..constants import IMAGE_DATA_MEAN, IMAGE_DATA_STDDEV


def normalize(img, mean: float = IMAGE_DATA_MEAN, std: float = IMAGE_DATA_STDDEV):
    """``(img - mean * max) / (std * max)``, max over the whole tensor. An
    all-zero volume divides by zero and gives NaN, as in the JAX package."""
    mx = img.max()
    return (img - mean * mx) / (std * mx)


def scale_intensity(img):
    """Min-max to [0, 1]."""
    mn, mx = img.min(), img.max()
    return (img - mn) / torch.clamp(mx - mn, min=1e-12)


def eval_transform(vol, mean: float = IMAGE_DATA_MEAN,
                   std: float = IMAGE_DATA_STDDEV):
    """Deterministic validation/inference transform of one volume."""
    return scale_intensity(normalize(vol, mean, std))


def eval_transform_batch(vols):
    """``eval_transform`` of each volume of a batch (B, ...), as the JAX
    package's ``vmap(eval_transform)``."""
    return torch.stack([eval_transform(v) for v in vols])
