"""Operations, bytes and peaks: the benchmark's yardstick, frozen here.

* ``layers``: every convolution and matrix product of a configuration's
  forward on one volume, from its sizes alone (the program is not read).
* ``forward_flops`` / ``train_flops``: the useful operations of one
  volume's forward, and of its forward and backward (the weight gradient
  of every layer, the input gradient of every layer but the first of each
  input, whose input needs none), at 2 operations a multiply-add; no
  recompute, no padded row, no elementwise work.
* ``bottleneck_calls``: the (M, K, N) of each call of the fused DenseNet
  bottleneck (BatchNorm + ReLU + 1x1x1 convolution) in one forward of a
  batch, in call order.
* ``fused_least_s``: the least time the card could take for one such call,
  each input read once and the output written once (x, w and out in the
  compute type, the folded scale and shift in float32), the operations at
  the type's peak: ``max(bytes / HBM, (2 M K N + 3 M K) / peak)``.
* ``PEAK_FLOPS``, ``HBM_BYTES_PER_S``: NVIDIA's data sheet for the H100 SXM at its 700 W limit,
  dense rates.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
POWER_LIMIT_W = 700.0
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def layers(model: dict, spatial) -> list[dict]:
    """Each product of one volume's forward: {"name", "macs", "first"}
    (``first``: its input is the model's, so no input gradient)."""
    out = []
    d, h, w = spatial
    c_in, feats = model["in_channels"], model["init_features"]
    stem = (d // 2) * (h // 2) * (w // 2)
    out.append({"name": "conv0", "macs": stem * feats * c_in * 7 ** 3,
                "first": True})
    vox = (d // 4) * (h // 4) * (w // 4)
    ch, growth, mid = feats, model["growth_rate"], \
        model["bn_size"] * model["growth_rate"]
    blocks = model["block_config"]
    for i, n in enumerate(blocks):
        for j in range(n):
            out.append({"name": f"block{i + 1}_layer{j + 1}.bottleneck",
                        "macs": vox * ch * mid, "first": False})
            out.append({"name": f"block{i + 1}_layer{j + 1}.conv2",
                        "macs": vox * mid * growth * 27, "first": False})
            ch += growth
        if i < len(blocks) - 1:
            out.append({"name": f"transition{i + 1}",
                        "macs": vox * ch * (ch // 2), "first": False})
            ch //= 2
            vox //= 8
    if model["kind"] == "densenet_blend":
        f = model["feature_layers"]
        out.append({"name": "feature_layer", "macs": ch * f, "first": False})
        prev = model["clinical_inputs"]
        for k, width in enumerate((32, 16, 8, 8, 8, f)):
            out.append({"name": f"mlp{k}", "macs": prev * width,
                        "first": k == 0})
            prev = width
        c = model["classes"]
        out.append({"name": "heads", "macs": (2 * f + f + f) * c,
                    "first": False})
    else:
        out.append({"name": "out", "macs": ch * model["classes"],
                    "first": False})
    return out


def forward_flops(model: dict, spatial) -> float:
    return 2.0 * sum(layer["macs"] for layer in layers(model, spatial))


def train_flops(model: dict, spatial) -> float:
    """Forward, weight gradients, and input gradients where needed."""
    return 2.0 * sum(layer["macs"] * (2 if layer["first"] else 3)
                     for layer in layers(model, spatial))


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
