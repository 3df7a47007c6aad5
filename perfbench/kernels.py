"""The kernel families that the per-layer metrics count, by name; a
kernel belongs to one family at most.

* ``elementwise``: PyTorch's own elementwise and reduction kernels
  (``at::native::...elementwise_kernel``, ``...reduce_kernel``): ReLU,
  dropout, the casts, the concatenations' copies, the augmentation's
  pointwise work, and train-mode BatchNorm where it takes the plain path.
* ``conv``: cuDNN's convolution kernels, named for their direction:
  ``fprop`` (forward), ``dgrad`` (data gradient), ``wgrad`` (weight
  gradient), as its ``xmma`` and ``cutlass`` engines name them, and
  ``convolve`` in its older engines' names. cuDNN's other kernels (layout
  transforms, normalisations) are in neither family.
* ``batch_norm``: the port's hand-written BatchNorm kernels
  (``kernels/csrc/batch_norm.cu``): the statistics with the running
  update, the normalise (+ ReLU), and the backward's sums and dx, of every
  ``models/common.BatchNorm`` and of the fused bottleneck's statistics.
"""

from __future__ import annotations

import re

ELEMENTWISE = re.compile(r"elementwise_kernel|reduce_kernel")
CONV = re.compile(r"fprop|dgrad|wgrad|convolve")
BATCH_NORM = re.compile(r"bn_stats_kernel|bn_normalize_kernel|"
                        r"bn_backward_sums_kernel|bn_backward_dx_kernel")


def family(name: str) -> str | None:
    """``"elementwise"``, ``"conv"``, ``"batch_norm"`` or None."""
    if ELEMENTWISE.search(name):
        return "elementwise"
    if CONV.search(name.lower()):
        return "conv"
    if BATCH_NORM.search(name):
        return "batch_norm"
    return None
