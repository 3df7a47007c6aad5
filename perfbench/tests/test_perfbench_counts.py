"""The frozen yardstick against the bounds the port's kernel table states
(PERF.md, the table of kernels): 58 bottleneck calls at batch 8 of
DenseNet121 at 64^3 take at least 0.0531 ms in bfloat16 and 0.1998 ms in
float32, DenseNet-264's 130 calls 0.0895 ms in bfloat16."""

import json

import pytest

from perfbench import counts
from perfbench.tests.conftest import REPO, config_cell

SPATIAL = (64, 64, 64)


def model(config):
    return json.loads((REPO / "perfbench" / "configs" /
                       f"{config}.json").read_text())["model"]


@pytest.mark.parametrize("config,dtype,calls,ms", [
    ("dn121_mmnn", "bfloat16", 58, 0.0531),
    ("dn121_mmnn", "float32", 58, 0.1998),
    ("dn264_3d", "bfloat16", 130, 0.0895),
    ("dn264_3d", "float32", 130, 0.3499),
])
def test_fused_bounds_reproduce_the_kernel_table(config, dtype, calls, ms):
    shapes = counts.bottleneck_calls(model(config), SPATIAL, 8)
    assert len(shapes) == calls
    least = sum(counts.fused_least_s(m, k, n, dtype) for m, k, n in shapes)
    assert round(least * 1e3, 4) == ms


def test_deepest_bottleneck_k():
    assert max(k for _, k, _ in counts.bottleneck_calls(
        model("dn264_3d"), SPATIAL, 8)) == 2656


def test_one_dense_layer_by_hand():
    """block1_layer1 of DenseNet121 on one 64^3 volume: the map is 16^3
    after the stem and the pool; the bottleneck takes 64 channels to 128,
    the 3^3 convolution 128 to 32."""
    layers = {l["name"]: l for l in counts.layers(config_cell("dn121_mmnn"))}
    vox = 16 ** 3
    assert 2 * layers["block1_layer1.bottleneck"]["macs"] == \
        2 * vox * 64 * 128 == 67_108_864
    assert 2 * layers["block1_layer1.conv2"]["macs"] == \
        2 * vox * 128 * 32 * 27 == 905_969_664


def test_training_counts_no_input_gradient_for_the_inputs():
    cell = config_cell("dn121_mmnn")
    layers = counts.layers(cell)
    first = sum(2.0 * l["macs"] for l in layers if l["first"])
    assert counts.train_flops(cell) == pytest.approx(
        3 * counts.forward_flops(cell) - first)
    assert 12.0e9 < counts.forward_flops(cell) < 12.3e9


def test_peaks():
    assert counts.PEAK_FLOPS == {"bfloat16": 989e12, "tf32": 495e12,
                                 "float32": 67e12}
    assert counts.HBM_BYTES_PER_S == 3.35e12
