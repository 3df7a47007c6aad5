"""mmnn_sts_torch.models vs the JAX package's flax models, eval mode.

Weights come from the JAX model's init with every BatchNorm's scale, bias
and running statistics (and every dense bias) redrawn with numpy from a
seed, then cross into the port through convert.py. The narrow DenseNet is
held against both JAX bottleneck paths: the unfused one and the Pallas
kernel in interpret mode (built directly, as tests/test_pallas.py does,
because the JAX registry never sets interpret mode). Tolerance rtol/atol
1e-4 (float32, different summation orders).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.mlp import MLP as JaxMLP
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.convert import from_jax_flat, load_jax_npz, to_jax_flat
from mmnn_sts_torch.exceptions import ConfigurationError
from mmnn_sts_torch.models import build_model
from mmnn_sts_torch.models.densenet import (
    DenseLayer, DenseNet, FusedBottleneck, bottleneck_shapes)
from mmnn_sts_torch.models.mlp import MLP
from mmnn_sts_torch.models.multimodal import MultiModalModel
from test_torch_convert import NARROW, jax_flat, jax_variables, randomise

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def port_eval(model, flat):
    load_jax_npz(model, flat)
    return model.eval()


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 16, 2)).astype(np.float32)
    unfused = JaxDenseNet(**NARROW)
    fused = JaxDenseNet(**NARROW, use_pallas=True, pallas_interpret=True)
    flat_u = randomise(
        jax_flat(unfused.init(jax.random.key(0), jnp.asarray(x))), seed=1)
    # the same weights in the fused1 layout, through the bridge
    flat_f = to_jax_flat(from_jax_flat(flat_u), layout="fused")
    fused_init = jax_flat(fused.init(jax.random.key(0), jnp.asarray(x)))
    assert {k: v.shape for k, v in flat_f.items()} == \
        {k: v.shape for k, v in fused_init.items()}
    want = {
        "unfused": np.asarray(unfused.apply(jax_variables(flat_u),
                                            jnp.asarray(x))),
        "fused": np.asarray(fused.apply(jax_variables(flat_f),
                                        jnp.asarray(x))),
    }
    return x, {"unfused": flat_u, "fused": flat_f}, want


@pytest.mark.parametrize("layout", ["unfused", "fused"])
def test_narrow_densenet_matches_jax(narrow, layout):
    """Port loaded from either checkpoint layout vs the JAX model of that
    layout (unfused XLA path, or the Pallas kernel in interpret mode)."""
    x, flats, want = narrow
    model = port_eval(DenseNet(**NARROW), flats[layout])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want[layout], **TOL)


def test_dense_activations_stay_channels_last(narrow):
    """Every dense layer hands on a channels-last tensor, so each
    bottleneck's (M, Cin) view is free (no copy per layer)."""
    x, flats, _ = narrow
    model = port_eval(DenseNet(**NARROW), flats["unfused"])
    seen = []
    for mod in model.modules():
        if isinstance(mod, (DenseLayer, FusedBottleneck)):
            mod.register_forward_hook(lambda m, i, o: seen.append(
                (i[0].is_contiguous(memory_format=torch.channels_last_3d),
                 o.is_contiguous(memory_format=torch.channels_last_3d))))
    with torch.no_grad():
        model(torch.from_numpy(x))
    assert len(seen) == 8 and all(a and b for a, b in seen)


def test_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 11)).astype(np.float32)
    jm = JaxMLP(in_channels=11, out_channels=2, feature_channels=12)
    flat = randomise(jax_flat(jm.init(jax.random.key(0), jnp.asarray(x))),
                     seed=3)
    want = np.asarray(jm.apply(jax_variables(flat), jnp.asarray(x)))
    model = port_eval(MLP(in_channels=11, out_channels=2,
                          feature_channels=12), flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_multimodal_blend_matches_jax():
    rng = np.random.default_rng(4)
    inputs = {"image": rng.normal(size=(3, 16, 16, 16, 2)).astype(np.float32),
              "clinical": rng.normal(size=(3, 11)).astype(np.float32)}
    jm = JaxMultiModal(image_model=JaxDenseNet(**NARROW),
                       num_clinical_inputs=11, num_classes=2, num_features=4,
                       blend=True)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    flat = randomise(jax_flat(jm.init(jax.random.key(0), jin)), seed=5)
    want = np.asarray(jm.apply(jax_variables(flat), jin))
    encoder = DenseNet(**{**NARROW, "out_channels": None})
    model = port_eval(MultiModalModel(encoder, 11, num_classes=2,
                                      num_features=4, blend=True), flat)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.shape == (3, 3, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name,bottlenecks", [("densenet121", 58),
                                              ("tinydensenet", 22)])
def test_registry_builds_fused_densenets(name, bottlenecks):
    cfg = Config()
    cfg.image_model.name = name
    model = build_model(cfg, images=True, preop=True, postop=False, blend=True)
    assert isinstance(model, MultiModalModel)
    assert model.clinical_model.dense_0.in_features == 11
    assert sum(isinstance(m, FusedBottleneck) for m in model.modules()) \
        == bottlenecks


def test_chip_smoke_inventory_is_densenet121s_bottlenecks():
    """chip_smoke.py holds the CUDA kernel against its plain version at the
    (M, Cin) of every bottleneck (densenet.bottleneck_shapes) of
    DenseNet121 and of the wider DenseNets it adds (chip_smoke.WIDE_MODELS:
    densenet169, 201 and 264): those must be what each model feeds them,
    in order (checked at 32^3, half the served side length, to keep the
    CPU forward small), 58 / 82 / 98 / 130 calls a forward, with K up to
    2,656 (densenet264's block 4)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from mmnn_sts_torch.models import densenet

    calls = {"densenet121": 58, "densenet169": 82, "densenet201": 98,
             "densenet264": 130}
    assert tuple(chip_smoke.WIDE_MODELS) == tuple(calls)[1:]
    for name, count in calls.items():
        model = getattr(densenet, name)(in_channels=2,
                                        out_channels=None).eval()
        seen = []
        for mod in model.modules():
            if isinstance(mod, FusedBottleneck):
                assert tuple(mod.kernel.shape[1:]) == \
                    (chip_smoke.BOTTLENECK_OUT,)
                mod.register_forward_pre_hook(lambda m, args: seen.append(
                    (args[0].shape[0] * args[0].shape[2:].numel(),
                     args[0].shape[1])))
        with torch.no_grad():
            model(torch.zeros(1, 32, 32, 32, 2), return_features=True)
        assert seen == [(m, cin) for _, m, cin in
                        bottleneck_shapes(model, 1, size=32)], name
        shapes = bottleneck_shapes(model, 8)
        assert len(shapes) == count, name
    assert max(k for _, _, k in shapes) == 2656
    assert {m for b, m, _ in shapes if b >= 3} == {512, 64}


@pytest.mark.parametrize("source", ["defaults", "config.example.yaml"])
def test_config_copy_reads_like_the_jax_package(source):
    """The port's own copy of config.py gives the same typed config as the
    JAX package's, from the dataclass defaults and from a YAML file."""
    import dataclasses

    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_tpu.config import Config as JaxConfig
    from mmnn_sts_tpu.config import parse_config as jax_parse_config

    if source == "defaults":
        port, ref = Config(), JaxConfig()
    else:
        path = os.path.join(REPO, source)
        port, ref = parse_config(path), jax_parse_config(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_registry_rejects_what_is_not_ported():
    """A name no registry knows raises as the JAX registry does; with
    ``spatial_dims: 2`` the flagship builds 2D (every convolution a 2D
    one, a (N, H, W, C) input), and ``r3d_18`` stays 3D as the JAX registry
    builds it (registry.py:106)."""
    from mmnn_sts_torch.models.common import Conv2d, Conv3d

    cfg = Config()
    cfg.image_model.name = "resnext101"
    with pytest.raises(ConfigurationError, match="not recognized"):
        build_model(cfg, images=True, preop=False, postop=False, blend=False)
    cfg.image_model.spatial_dims = 2
    for name, kind in (("densenet121", Conv2d), ("r3d_18", Conv3d)):
        cfg.image_model.name = name
        with torch.device("meta"):
            model = build_model(cfg, images=True, preop=True, postop=False,
                                blend=True) if name == "densenet121" else \
                build_model(cfg, images=True, preop=False, postop=False,
                            blend=False)
        convs = [m for m in model.modules()
                 if isinstance(m, (Conv2d, Conv3d))]
        assert convs and all(isinstance(m, kind) for m in convs), name


def test_config_example_builds_the_flagship_in_bf16():
    """config.example.yaml as shipped (compute_dtype bfloat16) builds the
    flagship multimodal blend model, which runs a forward at its 64^3 in
    bfloat16 with float32 parameters."""
    from mmnn_sts_torch.config import parse_config

    cfg = parse_config(os.path.join(REPO, "config.example.yaml"))
    assert cfg.tpu.compute_dtype == "bfloat16"
    model = build_model(cfg, images=True, preop=True, postop=False,
                        blend=True).eval()
    side = tuple(cfg.image_model.spatial_size)
    rng = np.random.default_rng(0)
    inputs = {"image": torch.from_numpy(rng.normal(size=(1,) + side + (2,))
                                        .astype(np.float32)),
              "clinical": torch.from_numpy(rng.normal(size=(1, 11))
                                           .astype(np.float32))}
    with torch.no_grad():
        out = model(inputs)
    assert out.shape == (3, 1, 2) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize("setting,value", [
    ("mesh_shape", [2]),
    ("mesh_shape", [-1, 4]),
    ("mesh_axes", ["data", "space"]),
])
def test_config_refuses_what_one_card_does_not_run(tmp_path, setting, value):
    """Every mesh parses, as in the JAX package: [-1] and [1] with
    ['data'], a 'space' axis and a 'model' axis of more than one device;
    ``parallel/mesh.make_mesh`` refuses a mesh of more than one device in
    a world of one rank with the JAX package's message."""
    import json

    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.parallel.mesh import make_mesh

    path = tmp_path / "config.json"
    for shape in ([-1], [1]):
        path.write_text(json.dumps({"TPU": {"mesh_shape": shape,
                                            "mesh_axes": ["data"]}}))
        assert parse_config(str(path)).tpu.mesh_shape == shape
    tpu = {setting: value}
    if setting == "mesh_axes":
        for shape, axes in (([-1, 2], value), ([1, 2], ["data", "model"])):
            path.write_text(json.dumps({"TPU": {"mesh_shape": shape,
                                                "mesh_axes": axes}}))
            cfg = parse_config(str(path))
            assert cfg.tpu.mesh_axes == axes
            with pytest.raises(ValueError, match="does not cover 1 devices"):
                make_mesh(cfg.tpu.mesh_shape, tuple(cfg.tpu.mesh_axes))
        return
    path.write_text(json.dumps({"TPU": tpu}))
    cfg = parse_config(str(path))
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        make_mesh(cfg.tpu.mesh_shape, tuple(cfg.tpu.mesh_axes))


def test_train_mode_is_refused():
    """Train mode runs, the random augmentation included (clinical rows
    pass it unchanged); what the superstep still refuses is a microbatch
    group below 1, before it changes the state."""
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    model = MLP(in_channels=11, out_channels=2)
    state = create_train_state(model, *make_optimizer(model.parameters(),
                                                      1e-2, 1, 1))
    args = (torch.zeros(1, 4, 11), torch.ones(1, 4, 2), torch.ones(1, 4, 2))
    with pytest.raises(ValueError, match="group"):
        survival_train_superstep(state, *args, augment=True, group=0)
    assert state.step == 0
    aux = survival_train_superstep(state, *args, augment=True)
    assert state.step == 1 and torch.isfinite(aux["loss"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("geometry", [(3, 2, 1), (2, 2, 0), (3, 1, 1)],
                         ids=["stem", "halving", "overlapping"])
def test_max_pool_backward_is_torch_bit_for_bit(dtype, layout, geometry):
    """The port's max pool (a fixed-order backward, so that the card's
    training step repeats its bits) gives torch's own forward and
    gradient bit for bit on the CPU, ties and a NaN included."""
    from mmnn_sts_torch.models.common import CHANNELS_LAST, max_pool

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 9, 8, 7), generator=gen).to(dtype)
    x[0, 0, 0, 0, 1] = x[0, 0, 0, 0, 0]  # a tie
    x[1, 2, 4, 4, 4] = float("nan")
    if layout == "channels_last":
        x = x.to(memory_format=CHANNELS_LAST)
    mine, theirs = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = max_pool(mine, *geometry)
    want = torch.nn.functional.max_pool3d(theirs, *geometry)
    g = torch.randn(out.shape, generator=gen).to(dtype)
    out.backward(g)
    want.backward(g)
    assert torch.equal(out.nan_to_num(), want.nan_to_num())
    assert torch.equal(mine.grad, theirs.grad)
    assert mine.grad.stride() == theirs.grad.stride()


def test_chip_smoke_phases_select_what_they_need():
    """``chip_smoke.py --phases``: no name runs every phase; a phase brings
    the phases it reads (mesh_phase the CLI phase's cohort, s3_cli_phase
    the DICOM tree and the cohort); an unknown name raises before the
    build; every phase the script can run is in ``PHASES``."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.selected_phases("") == set(chip_smoke.PHASES)
    assert chip_smoke.selected_phases("planar_phase,mesh_phase") == {
        "planar_phase", "mesh_phase", "cli_phase"}
    assert chip_smoke.selected_phases(" s3_cli_phase ") == {
        "s3_cli_phase", "dicom_cli_phase", "cli_phase"}
    with pytest.raises(SystemExit, match="unknown phases"):
        chip_smoke.main(["--phases", "kernel_phase,warp_phase"])
    for needs in chip_smoke.PHASES.values():
        assert set(needs) <= set(chip_smoke.PHASES)
    defined = {name for name in vars(chip_smoke)
               if name.endswith("_phase") and callable(
                   getattr(chip_smoke, name))}
    assert defined == set(chip_smoke.PHASES)


def test_chip_smoke_kernels_line_reports_no_unmeasured_number():
    """Where no phase ran, the kernels line holds None for every number, not
    a 0 that reads as measured; a kernel phase's rows fill its sums."""
    sys.path.insert(0, REPO)
    import chip_smoke

    for entry in chip_smoke.kernels_line({}):
        assert set(entry) >= {"name", "route", "source", "replaces",
                              "launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms"}
        for key, value in entry.items():
            if key not in ("name", "route", "source", "replaces"):
                assert value is None, (entry["name"], key, value)
    row = {"batch": 8, "dtype": "float32", "ms": 2.0, "plain_ms": 3.0,
           "bound_ms": 1.0, "bound_by": "bytes", "gemm_ms": 1.5,
           "host_us": 4.0, "max_abs_err": 1e-6}
    fp32, bf16, stamp, bn = chip_smoke.kernels_line(
        {"kernel_phase": [row, row]})
    assert (fp32["ms"], fp32["plain_ms"], fp32["bound_ms"],
            fp32["host_us_per_call"], fp32["bound_by"]) == (
        4.0, 6.0, 2.0, 4.0, "bytes")
    assert fp32["per_rank_of_two_ms"] is None and fp32["backward_ms"] is None
    assert bf16["ms"] is None and bf16["max_abs_err"] is None
    assert stamp["name"] == "span_stamp" and stamp["launches"] is None
    assert bn["name"] == "batch_norm" and bn["ms"] is None
