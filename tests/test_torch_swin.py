"""The Swin UNETR encoder (``models/swin.py``, ``ops/window_attention.py``)
against the benchmark's plain reference of it
(``perfbench/reference/kinds/swin_blend.py``, loaded by file as the
benchmark's ``Cell.family`` loads it), on seeded random weights at a
tiny size on the CPU: 32³ × 2 volumes, ``feature_size`` 12, heads
1-2-4-8. At window 3 the grids of 16³, 8³ and 4³ are padded to whole
windows and shifted on odd blocks, and the 2³ stage clips its window to
the grid (the ``[:n, :n]`` corner of the index); at window 4 nothing is
padded and the 4³ stage is one unshifted window.

Tolerances, float32 on both sides: the two differ in the order of their
sums alone (SDPA's math path scales q and k by d^-1/4 each where the
reference scales q by d^-1/2; ``F.layer_norm`` against the written-out
mean and variance; the chunked attention), each a few ulps a value, so
an output or gradient may lie 1e-4 of its tensor's largest magnitude
from the reference (the readings are 1e-6 or below); a wrong mask, bias
index, shift or window order moves them by 1e-2 or more.

Also: the blend model with a masked tail, the weight bridge's exact
round trip, supersteps of the survival loop through the benchmark's own
check, and the configurations the encoder refuses. JAX-free; the card's
test is ``tests/test_torch_swin_cuda.py``.
"""

import functools
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mmnn_sts_torch import convert
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.exceptions import ConfigurationError
from mmnn_sts_torch.models import registry, swin
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.ops import window_attention

REPO = Path(__file__).resolve().parents[1]
FAMILY = REPO / "perfbench" / "reference" / "kinds" / "swin_blend.py"
SIDE = 32
TOL = 1e-4


def family():
    spec = importlib.util.spec_from_file_location("swin_family", FAMILY)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_model_cfg(window: int) -> dict:
    return {"kind": "swin_blend", "in_channels": 2, "feature_size": 12,
            "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8],
            "window_size": window, "patch_size": 2, "mlp_ratio": 4,
            "qkv_bias": True, "feature_layers": 12, "classes": 2,
            "image_dropout": 0.2, "clinical_dropout": 0.2,
            "clinical_inputs": 11}


def tiny_swin(window: int, dtype=None) -> swin.SwinViT:
    return swin.SwinViT(in_channels=2, feature_channels=12, dropout_prob=0.2,
                        dtype=dtype, feature_size=12, heads=(1, 2, 4, 8),
                        window=window)


def randomised(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter drawn anew, so that biases, LayerNorms and the bias
    table are not at their initial constants."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3
                    + (1.0 if p.dim() == 1 else 0.0) * (p == 1).float())
    return model


def volumes(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, SIDE, SIDE, SIDE, 2), generator=g)


def assert_close(got, want, what):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


def compare_grads(program, reference):
    ref = dict(reference.named_parameters())
    names = [k for k, _ in program.named_parameters()]
    assert sorted(names) == sorted(ref)
    for k, p in program.named_parameters():
        assert p.grad is not None and ref[k].grad is not None, k
        assert_close(p.grad, ref[k].grad, k)


@pytest.mark.parametrize("window", [3, 4])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_encoder_forward_and_gradients_match_the_reference(window, mode):
    program = randomised(tiny_swin(window), 1)
    reference = family().SwinEncoder(tiny_model_cfg(window), "float32")
    reference.load_state_dict(program.state_dict(), strict=True)
    program.train(mode == "train")
    reference.train(mode == "train")
    x = volumes(2, 2)
    got = program(x, return_features=True,
                  generator=torch.Generator().manual_seed(3))
    want = reference(x, generator=torch.Generator().manual_seed(3))
    assert_close(got, want, "features")
    weights = torch.linspace(-1.0, 1.0, got.numel()).view(got.shape)
    (got * weights).sum().backward()
    (want * weights).sum().backward()
    compare_grads(program, reference)


def test_blend_model_with_a_masked_tail_matches_the_reference():
    """Two of four rows masked: the clinical BatchNorms' statistics leave
    them out, and the rows' outputs and the gradients match."""
    program = randomised(MultiModalModel(tiny_swin(3), 11, 2, 12,
                                         blend=True), 4)
    reference = family().build(tiny_model_cfg(3))
    reference.load_state_dict(program.state_dict(), strict=True)
    g = torch.Generator().manual_seed(5)
    inputs = {"image": volumes(4, 6),
              "clinical": torch.randn((4, 11), generator=g)}
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    got = program(inputs, sample_mask=mask,
                  generator=torch.Generator().manual_seed(7))
    want = reference(inputs, mask,
                     generator=torch.Generator().manual_seed(7))
    assert got.shape == want.shape == (3, 4, 2)
    assert_close(got[:, :2], want[:, :2], "valid rows")
    got[:, :2].sum().backward()
    want[:, :2].sum().backward()
    compare_grads(program, reference)
    for k, v in reference.state_dict().items():
        if "running" in k:
            assert_close(program.state_dict()[k], v, k)


def test_npz_round_trip_is_bit_exact(tmp_path):
    """``to_jax_flat`` then ``load_jax_npz`` (strict) gives every tensor
    back bit for bit; LayerNorm leaves are flax's ``scale``/``bias``, the
    bias table keeps its name, and no index or mask is saved."""
    model = randomised(MultiModalModel(tiny_swin(3), 11, 2, 12, blend=True),
                       8)
    flat = convert.to_jax_flat(model.state_dict())
    assert "params/image_model/layers1/blocks/0/norm1/scale" in flat
    assert "params/image_model/layers1/downsample/norm/scale" in flat
    table = "params/image_model/layers2/blocks/1/attn/" \
        "relative_position_bias_table"
    assert flat[table].shape == (5 ** 3, 2)
    assert not any("index" in k or "mask" in k for k in flat)
    np.savez(tmp_path / "best.npz", **flat)
    back = MultiModalModel(tiny_swin(3), 11, 2, 12, blend=True)
    convert.load_jax_npz(back, tmp_path / "best.npz")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_export_loads_a_best_save_strictly(tmp_path):
    """``infer/export`` reads the loop's best ``.npz`` of the published
    encoder (at 32³, the smallest size it takes) into a servable that
    loads strictly, every weight as saved."""
    from mmnn_sts_torch.infer import export

    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({"ImageModel": {
        "name": "swinvit", "spatial_size": [SIDE] * 3}}))
    cfg = Config()
    cfg.image_model.name = "swinvit"
    cfg.image_model.spatial_size = [SIDE] * 3
    model = registry.build_model(cfg, True, True, False, True)
    np.savez(tmp_path / "best.npz", **convert.to_jax_flat(model.state_dict()))
    out = tmp_path / "servable.pt"
    assert export.main(["--config", str(cfg_path), "--weights",
                        str(tmp_path / "best.npz"), "--images", "--preop",
                        "--blend", "--out", str(out), "--device",
                        "cpu"]) == 0
    served, _ = export.load_exported(str(out), "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k


def test_survival_supersteps_through_the_loop_match_the_reference(
        tmp_path, monkeypatch):
    """The benchmark's check on a tiny Swin blend cell: the program's
    survival loop (``train_survival``, two warm-up epochs of two
    supersteps, the second a masked tail; augmentation and dropout on)
    against the reference followed from the same seed, in float32."""
    from perfbench import check
    from perfbench.cells import resolve
    from perfbench.tests.conftest import write_tiny_root
    from perfbench.training import run_program

    monkeypatch.setattr(registry, "SwinViT", functools.partial(
        swin.SwinViT, feature_size=12, heads=(1, 2, 4, 8), window=3))
    name = write_tiny_root(tmp_path, "dn121_mmnn.train_fused_fp32",
                           model=tiny_model_cfg(3), image_model="swinvit")
    pb = tmp_path / "perfbench"
    config = json.loads((pb / "configs" / "tiny.json").read_text())
    config["ImageModel"]["spatial_size"] = [SIDE] * 3
    (pb / "configs" / "tiny.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "tiny_mix.json").read_text())
    traffic.update(train_patients=72, val_patients=8, warmup_epochs=2)
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps(traffic))
    cell = resolve(name, tmp_path)
    device = torch.device("cpu")
    before = dict(window_attention.counts)
    run = run_program(cell, 2 ** 40 + 11, 0.0, False, device,
                      time.perf_counter())
    assert len(run.step_losses) == 4
    ref = check.reference_side(cell, run, device)
    values = check.readings(check.program_side(run, ref["weights"]), ref)
    for number in ("loss_gap", "grad_gap_median", "update_gap_median",
                   "val_gap"):
        assert values[number] < 1e-4, values
    # eight blocks a forward; on the CPU every call is the math path's
    calls = window_attention.counts["calls"] - before["calls"]
    assert calls > 0 and calls % 8 == 0
    assert window_attention.counts["math_calls"] - before["math_calls"] \
        == calls


def test_the_index_is_a_buffer_remade_after_to_empty():
    """The relative-position index is no weight: it is not saved, and a
    model built on the meta device and moved by ``to_empty`` (as the
    benchmark builds the program) holds the index's values."""
    with torch.device("meta"):
        model = tiny_swin(3)
    model = model.to_empty(device="cpu")
    want = swin.relative_position_index(3)
    blocks = [b for i in range(4) for b in getattr(model, f"layers{i + 1}")
              .blocks]
    for block in blocks:
        assert torch.equal(block.attn.relative_position_index, want)
    assert not any("index" in k for k in model.state_dict())


@pytest.mark.parametrize("window", [3, 4])
def test_the_mask_handed_to_sdpa_has_unit_stride(window, monkeypatch):
    """The fused kernels take only a mask whose last dim has unit stride;
    at window 4 the 4³ stage's 64-token rows need no padding, and the
    bias's own layout (heads innermost) must not reach the kernel."""
    real = window_attention.F.scaled_dot_product_attention
    strides = []

    def spy(q, k, v, attn_mask=None, scale=None):
        strides.append(attn_mask.stride(-1))
        return real(q, k, v, attn_mask=attn_mask, scale=scale)

    monkeypatch.setattr(window_attention.F, "scaled_dot_product_attention",
                        spy)
    tiny_swin(window)(volumes(1, 0), return_features=True)
    assert len(strides) == 8 and set(strides) == {1}


def test_batches_past_the_kernels_grid_run_in_chunks(monkeypatch):
    """A call of more sequences than the kernel's grid takes runs in chunks
    of the batch and gives the unchunked values bit for bit."""
    model = randomised(tiny_swin(3), 9).eval()
    x = volumes(2, 10)
    whole = model(x, return_features=True)
    monkeypatch.setattr(window_attention, "MAX_GRID", 5)
    assert torch.equal(model(x, return_features=True), whole)


def full_config(**tpu) -> Config:
    cfg = Config()
    cfg.image_model.name = "swinvit"
    cfg.image_model.spatial_size = [96, 96, 96]
    for key, value in tpu.items():
        setattr(cfg.tpu, key, value)
    return cfg


def test_registry_builds_the_published_encoder_in_the_multimodal_model():
    with torch.device("meta"):
        model = registry.build_model(full_config(), True, True, False, True)
    enc = model.image_model
    assert isinstance(enc, swin.SwinViT)
    assert enc.patch_embed.weight.shape == (48, 2, 2, 2, 2)
    for i, heads in enumerate(swin.HEADS):
        block = getattr(enc, f"layers{i + 1}").blocks[1]
        assert block.attn.relative_position_bias_table.shape == (13 ** 3,
                                                                heads)
        assert block.mlp.linear1.weight.shape == (4 * 48 * 2 ** i,
                                                  48 * 2 ** i)
    assert enc.feature_layer.weight.shape == (12, 768)


@pytest.mark.parametrize("change", [
    {"spatial_dims": 2}, {"spatial_size": [96, 96, 80]},
    {"mesh_axes": ["data", "space"], "mesh_shape": [1, 2]},
    {"mesh_axes": ["model"], "mesh_shape": [2]}])
def test_registry_refuses(change):
    cfg = full_config()
    for key, value in change.items():
        target = cfg.tpu if key.startswith("mesh") else cfg.image_model
        setattr(target, key, value)
    with torch.device("meta"), pytest.raises(ConfigurationError):
        registry.build_model(cfg, True, True, False, True)


def test_gradcam_is_refused():
    with pytest.raises(ConfigurationError, match="no_gradcam"):
        tiny_swin(3)(volumes(1, 0), capture_gradcam=True)


def test_window_geometry_and_shift_mask_follow_monai():
    assert swin.window_geometry((48, 48, 48), 7, 3) == ((7, 7, 7), (3, 3, 3))
    assert swin.window_geometry((6, 6, 6), 7, 3) == ((6, 6, 6), (0, 0, 0))
    mask = swin.shift_mask((14, 14, 14), (7, 7, 7), (3, 3, 3), "cpu")
    assert mask.shape == (8, 343, 343)
    assert not mask[0].any()  # the first window holds one region
    # the last window holds eight regions of 4 x 4 x 4 ... 3 x 3 x 3 tokens
    last = (mask[-1] == 0).sum(1)
    assert sorted(set(last.tolist())) == [27, 36, 48, 64]
    index = swin.relative_position_index(7)
    assert index.shape == (343, 343) and int(index.max()) == 13 ** 3 - 1
    assert int(index[0, 0]) == (6 * 13 + 6) * 13 + 6
