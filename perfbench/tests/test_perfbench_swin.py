"""The ``swin_mmnn`` configuration and its cell: the cell resolves to the
``swin_blend`` family; the family's weight spec loads strictly into the
program's ``swinvit`` blend model; its ``layers`` give the count written
out here from the published sizes; and the two readers of the windowed
attention read nothing without a trace, count the forward launches they
expect, and give the roofline share from the calls' least times."""

import math
import types

import pytest
import torch

from perfbench import attention, counts
from perfbench.cells import resolve
from perfbench.reference import common
from perfbench.tests.conftest import REPO
from perfbench.trace import Trace
from perfbench.training import program_config

CELL = "swin_mmnn.train_fused_bf16"
READERS = ("window_attention_ms_per_step",
           "window_attention_fwd_roofline.bf16")


@pytest.fixture(scope="module")
def cell():
    return resolve(CELL, REPO)


def test_the_cell_resolves_to_its_family(cell):
    family = cell.family()
    assert cell.config["model"]["kind"] == "swin_blend"
    assert cell.config["ImageModel"]["name"] == "swinvit"
    assert cell.config["ImageModel"]["spatial_size"] == [96, 96, 96]
    assert cell.traffic["TPU"]["compute_dtype"] == "bfloat16"
    for name in ("build", "layers", "init_kind"):
        assert callable(getattr(family, name))
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names


def test_weight_spec_loads_strictly_into_the_program(cell):
    from mmnn_sts_torch.models import build_model

    spec = common.weight_spec(cell.family(), cell.config["model"])
    with torch.device("meta"):
        model = build_model(program_config(cell), True, True, False, True,
                            num_tabular_inputs=11)
        weights = {k: torch.empty(shape) for k, shape in spec}
    model.load_state_dict(weights, strict=True, assign=True)
    init = cell.family().init_kind
    table = "image_model.layers1.blocks.0.attn.relative_position_bias_table"
    assert dict(spec)[table] == (13 ** 3, 3)
    assert init(table, (13 ** 3, 3)) == init(
        "image_model.layers4.blocks.1.mlp.linear2.weight", (384, 1536))
    assert init("image_model.layers1.blocks.0.norm1.weight", (48,)) == (
        "ones", 0)
    assert init("image_model.feature_layer.weight", (12, 768)) == (
        "lecun", 768)


def test_layers_match_the_published_count(cell):
    """Patch 2 at 96³ gives 48³ tokens of 48 channels; windows of 7³ pad
    the grids of 48, 24 and 12 to 49, 28 and 14, and the 6³ grid is one
    window of 216 tokens; each merging halves the grid and doubles C."""
    image = 48 ** 3 * 48 * 2 * 8 + 768 * 12
    for grid, padded, window, c in ((48, 49, 343, 48), (24, 28, 343, 96),
                                    (12, 14, 343, 192), (6, 6, 216, 384)):
        tokens = grid ** 3
        per_block = (tokens * c * 3 * c + tokens * c * c
                     + 2 * tokens * c * 4 * c
                     + 2 * padded ** 3 * window * c)
        image += 2 * per_block + (grid // 2) ** 3 * 8 * c * 2 * c
    family = cell.family().layers(cell.config["model"], [96, 96, 96])
    assert sum(layer["macs"] for layer in family) == image
    assert [layer["first"] for layer in family].count(True) == 1
    clinical = 11 * 32 + 32 * 16 + 16 * 8 + 8 * 8 + 8 * 8 + 8 * 12
    heads = (2 * 12 + 12 + 12) * 2
    assert counts.forward_flops(cell) == 2.0 * (image + clinical + heads)


def test_forward_calls_and_their_least_time(cell):
    model = cell.config["model"]
    calls = attention.forward_calls(model, [96] * 3, 8)
    assert [c[1:] for c in calls] == [
        (343, 343, 48, 3, False), (343, 343, 48, 3, True),
        (64, 343, 96, 6, False), (64, 343, 96, 6, True),
        (8, 343, 192, 12, False), (8, 343, 192, 12, True),
        (1, 216, 384, 24, False), (1, 216, 384, 24, False)]
    # the first stage's shifted call: q, k, v and the output of 8 volumes,
    # each window's mask; bound by the bytes
    moved = (4 * 8 * 343 * 343 * 48 + 3 * 343 * 343 * 343) * 2
    flops = 4.0 * 8 * 343 * 343 ** 2 * 48
    assert moved / counts.HBM_BYTES_PER_S > flops / counts.PEAK_FLOPS[
        "bfloat16"]
    assert attention.least_s(calls[1], "bfloat16") == pytest.approx(
        moved / counts.HBM_BYTES_PER_S)


@pytest.mark.parametrize("reader", READERS)
def test_readers_read_nothing_without_a_trace(cell, reader):
    run = types.SimpleNamespace(trace=None, profiled={})
    assert cell.reader(reader)(run, cell) is None


def profiled_run(names):
    device = [(name, 2.0 * i, 2.0 * i + 1e-3) for i, name in
              enumerate(names)]
    return types.SimpleNamespace(
        trace=Trace(0.0, 1e6, device, []),
        profiled={"supersteps": 8, "accum": 8, "micro_batch": 8,
                  "val_volumes": 96, "train_volumes": 480})


def test_readers_count_the_attention_kernels(cell):
    fwd = "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(Params)"
    bwd = "fmha_cutlassB_bf16_aligned_64x64_k32_sm80(Params)"
    expected = 8 * 8 * 8 + 8  # 8 calls a forward: 64 microbatches + val
    run = profiled_run([fwd] * expected + [bwd] * 512
                       + ["sm90_xmma_fprop_implicit_gemm"])
    ms = cell.reader("window_attention_ms_per_step")(run, cell)
    assert ms == pytest.approx(1e3 * (expected + 512) * 1e-3 / 8)
    share = cell.reader("window_attention_fwd_roofline.bf16")(run, cell)
    model = cell.config["model"]
    least = (64 * sum(attention.least_s(c, "bfloat16") for c in
                      attention.forward_calls(model, [96] * 3, 8))
             + sum(attention.least_s(c, "bfloat16") for c in
                   attention.forward_calls(model, [96] * 3, 96)))
    assert share == pytest.approx(100.0 * least / (expected * 1e-3))
    # a launch more or fewer than the calls counted: nothing read
    short = profiled_run([fwd] * (expected - 1))
    assert cell.reader("window_attention_fwd_roofline.bf16")(
        short, cell) is None
    assert math.isfinite(cell.reader("window_attention_ms_per_step")(
        short, cell))


def test_no_other_kernel_family_claims_the_attention_kernels():
    from perfbench import kernels

    for name in ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80",
                 "fmha_cutlassB_bf16_aligned_64x64_k32_sm80"):
        assert kernels.family(name) is None
        assert attention.KERNELS.search(name)
