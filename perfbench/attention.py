"""The windowed attention's calls, operations and bytes, from a
configuration's sizes alone (the program is not read), for the readers of
``window_attention_*``.

A configuration whose ``model`` section has ``window_size`` runs, in each
block of each stage, one windowed attention call over the padded grid:
the patch embedding divides the volume by ``patch_size``, each stage's
patch merging halves the grid (rounding up) and doubles the channels from
``feature_size``. In a block, an axis no longer than the window takes a
window of its own size and no shift; odd blocks shift (where some axis is
longer than the window) and then carry a mask of their own for each
window.

* ``forward_calls(model, spatial, batch)``: ``(batch, windows, tokens,
  channels, heads, shifted)`` of each call of one forward on ``batch``
  volumes (``windows`` a volume's), in call order.
* ``least_s(call, dtype)``: the least time the card could take for a
  forward call: ``max(4 B W N² C / peak, bytes / HBM)``, the two products
  of every window's heads at the type's peak; q, k and v read once, the
  output written once, and the additive mask read once at the size the
  program materialises it (each head's bias, and for a shifted block each
  window's: broadcast over the batch either way).
* ``KERNELS``, ``FORWARD``: the SDPA kernels the program launches (the
  memory-efficient backend's CUTLASS kernels), all and forward alone.
"""

from __future__ import annotations

import math
import re

from .counts import DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS

KERNELS = re.compile(r"fmha_cutlass")
FORWARD = re.compile(r"fmha_cutlassF")


def forward_calls(model: dict, spatial, batch: int) -> list[tuple]:
    window = model["window_size"]
    grid = [s // model["patch_size"] for s in spatial]
    channels = model["feature_size"]
    calls = []
    for depth, heads in zip(model["depths"], model["num_heads"]):
        sides = [min(window, g) for g in grid]
        windows = math.prod(math.ceil(g / k) for g, k in zip(grid, sides))
        for block in range(depth):
            shifted = block % 2 == 1 and any(g > window for g in grid)
            calls.append((batch, windows, math.prod(sides), channels, heads,
                          shifted))
        grid = [math.ceil(g / 2) for g in grid]
        channels *= 2
    return calls


def least_s(call: tuple, dtype: str) -> float:
    batch, windows, tokens, channels, heads, shifted = call
    size = DTYPE_BYTES[dtype]
    flops = 4.0 * batch * windows * tokens * tokens * channels
    mask = heads * tokens * tokens * (windows if shifted else 1)
    moved = (4 * batch * windows * tokens * channels + mask) * size
    return max(flops / PEAK_FLOPS[dtype], moved / HBM_BYTES_PER_S)
