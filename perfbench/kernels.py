"""The kernel families that the per-layer metrics count, by name; a
kernel belongs to one family at most.

* ``elementwise``: PyTorch's own elementwise and reduction kernels
  (``at::native::...elementwise_kernel``, ``...reduce_kernel``): train-mode
  BatchNorm, ReLU, dropout, the casts, the augmentation's pointwise work.
* ``conv``: cuDNN's convolution kernels, named for their direction:
  ``fprop`` (forward), ``dgrad`` (data gradient), ``wgrad`` (weight
  gradient), as its ``xmma`` and ``cutlass`` engines name them, and
  ``convolve`` in its older engines' names. cuDNN's other kernels (layout
  transforms, normalisations) are in neither family.
"""

from __future__ import annotations

import re

ELEMENTWISE = re.compile(r"elementwise_kernel|reduce_kernel")
CONV = re.compile(r"fprop|dgrad|wgrad|convolve")


def family(name: str) -> str | None:
    """``"elementwise"``, ``"conv"`` or None."""
    if ELEMENTWISE.search(name):
        return "elementwise"
    if CONV.search(name.lower()):
        return "conv"
    return None
