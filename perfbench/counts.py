"""Operations, bytes and peaks: the benchmark's yardstick, frozen here.

* ``layers``: every convolution and matrix product of a cell's forward on
  one volume, from its configuration's sizes alone (the program is not
  read): the image encoder's, from its model family's ``layers``
  (``perfbench/reference/kinds/<kind>.py``), then the clinical MLP's six
  and the fusion head where ``flags.preop`` builds the multimodal model,
  and the image and clinical heads where ``flags.blend`` adds them.
* ``forward_flops`` / ``train_flops``: the useful operations of one
  volume's forward, and of its forward and backward (the weight gradient
  of every layer, the input gradient of every layer but the first of each
  input, whose input needs none), at 2 operations a multiply-add; no
  recompute, no padded row, no elementwise work.
* ``bottleneck_calls``: the (M, K, N) of each call of the fused DenseNet
  bottleneck (BatchNorm + ReLU + 1x1x1 convolution) in one forward of a
  batch, in call order, from a DenseNet's block configuration.
* ``fused_least_s``: the least time the card could take for one such call,
  each input read once and the output written once (x, w and out in the
  compute type, the folded scale and shift in float32), the operations at
  the type's peak: ``max(bytes / HBM, (2 M K N + 3 M K) / peak)``.
* ``PEAK_FLOPS``, ``HBM_BYTES_PER_S``: NVIDIA's data sheet for the H100 SXM at its 700 W limit,
  dense rates.
"""

from __future__ import annotations

from .reference.common import MLP_WIDTHS

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
POWER_LIMIT_W = 700.0
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def layers(cell) -> list[dict]:
    """Each product of one volume's forward: {"name", "macs", "first"}
    (``first``: its input is the model's, so no input gradient)."""
    model, flags = cell.config["model"], cell.config["flags"]
    out = list(cell.family().layers(
        model, cell.config["ImageModel"]["spatial_size"]))
    if flags["preop"]:
        f = model["feature_layers"]
        prev = model["clinical_inputs"]
        for k, width in enumerate(MLP_WIDTHS + (f,)):
            out.append({"name": f"mlp{k}", "macs": prev * width,
                        "first": k == 0})
            prev = width
        heads = 2 * f + (f + f if flags["blend"] else 0)
        out.append({"name": "heads", "macs": heads * model["classes"],
                    "first": False})
    return out


def forward_flops(cell) -> float:
    return 2.0 * sum(layer["macs"] for layer in layers(cell))


def train_flops(cell) -> float:
    """Forward, weight gradients, and input gradients where needed."""
    return 2.0 * sum(layer["macs"] * (2 if layer["first"] else 3)
                     for layer in layers(cell))


def bottleneck_calls(model: dict, spatial, batch: int) -> list[tuple]:
    """(M, K, N) of each fused bottleneck call of a forward on ``batch``
    volumes."""
    d, h, w = (s // 4 for s in spatial)
    ch, growth = model["init_features"], model["growth_rate"]
    mid = model["bn_size"] * growth
    calls = []
    for i, n in enumerate(model["block_config"]):
        vox = (d >> i) * (h >> i) * (w >> i)
        for _ in range(n):
            calls.append((batch * vox, ch, mid))
            ch += growth
        ch //= 2
    return calls


def fused_least_s(m: int, k: int, n: int, dtype: str) -> float:
    size = DTYPE_BYTES[dtype]
    moved = (m * k + k * n + m * n) * size + 2 * k * 4
    ops = 2 * m * k * n + 3 * m * k
    return max(moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])
