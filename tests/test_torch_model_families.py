"""The image model families beyond DenseNet121 and TinyDenseNet, held
against the JAX package on the CPU: ``tinycnn``, ``monaidensenet``,
``densenet169``, ``densenet201``, ``densenet264`` (the vanilla DenseNet
head), ``seresnet50`` and ``r3d_18``.

* The registry's model at full width (``Config()`` defaults, 64^3 x 2ch):
  its flat key set and shapes equal the JAX registry's model's
  (``jax.eval_shape`` of its init; the port's on the meta device).
* At a small size, on the same weights (the port's init with every
  BatchNorm and bias redrawn with numpy, carried across by ``convert.py``):
  the eval forward, and in train mode (dropout 0) the output and the
  running statistics. The DenseNets are narrow (``init_features`` 8,
  ``growth_rate`` 4) with each family's own blocks, at 32^3; the others at
  16^3 with their own widths. The train-mode check runs for tinycnn,
  r3d_18, seresnet50 and monaidensenet; densenet169/201/264 share its code
  and only its depth differs, which the eval forward and the key set
  cover (tracing a 130-layer flax model twice costs ~30 s here).
* Each family's ``to_jax_flat`` round trip, its servable, a masked
  superstep, TinyCNN in bfloat16 and inside the multimodal blend model,
  TinyCNN's Grad-CAM maps against JAX's, and the refusals: a multimodal
  model of another family (JAX's message), Grad-CAM of seresnet50 and
  r3d_18 (which JAX cannot draw; the message names ``--no_gradcam``) and
  an unknown name; ``spatial_dims: 2`` builds tinycnn 2D and r3d_18 3D.
* One image-only CLI run (``--images --survival --split``, tinycnn): its
  best ``.npz`` loads into the JAX model, which gives the port's eval
  outputs.

Tolerances (float32; max |port - JAX| <= TOL x max(1, max |JAX|)), each
set from the error measured here: eval 1e-5 everywhere (measured <= 4e-7
relative; SE-ResNet50's 16 blocks 4e-7). Train mode 1e-5 for tinycnn and
r3d_18 (measured 1e-7 and 2e-6) and 1e-3 for seresnet50 and
monaidensenet (measured 2.6e-4 and 2e-4): train-mode BatchNorm takes
``E[x^2] - mean^2`` summed in another order, and at the last blocks
(1^3 x 8 samples) that cancellation reaches 1e-4 of a layer's output,
which the later BatchNorms pass on.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from fixtures import make_full_cohort
from mmnn_sts_tpu.config import Config as JaxConfig
from mmnn_sts_tpu.models import build_model as jax_build_model
from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.models.resnet3d import ResNet3D18 as JaxResNet3D18
from mmnn_sts_tpu.models.seresnet import SEResNet50 as JaxSEResNet50
from mmnn_sts_tpu.models.tinycnn import TinyCNN as JaxTinyCNN
from mmnn_sts_tpu.ops.gradcam import attention_maps as jax_attention_maps
from mmnn_sts_torch.cli import main as port_main
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.convert import from_jax_flat, load_jax_npz, to_jax_flat
from mmnn_sts_torch.exceptions import ConfigurationError
from mmnn_sts_torch.infer.export import (
    ServingModel, export_forward, model_spec)
from mmnn_sts_torch.models import build_model
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.models.resnet3d import ResNet3D18
from mmnn_sts_torch.models.seresnet import SEResNet50
from mmnn_sts_torch.models.tinycnn import TinyCNN
from mmnn_sts_torch.ops.gradcam import attention_maps
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import survival_train_superstep
from test_torch_bf16 import PATHS, call, check_against_jax
from test_torch_convert import jax_flat, jax_variables, randomise

torch.set_num_threads(1)

NAMES = ("tinycnn", "monaidensenet", "densenet169", "densenet201",
         "densenet264", "seresnet50", "r3d_18")
EVAL_TOL = 1e-5
TRAIN_TOL = {"tinycnn": 1e-5, "r3d_18": 1e-5, "seresnet50": 1e-3,
             "monaidensenet": 1e-3}
NARROW = dict(init_features=8, growth_rate=4, in_channels=2, out_channels=2)
BLOCKS = {"monaidensenet": (6, 12, 24, 16), "densenet169": (6, 12, 32, 32),
          "densenet201": (6, 12, 48, 32), "densenet264": (6, 12, 64, 48)}


def _small(name, dropout=0.0, dtype=None):
    """(port model, JAX model, input side) of ``name`` at a small size,
    built with the same arguments on both sides."""
    if name in BLOCKS:
        kw = dict(NARROW, block_config=BLOCKS[name], feature_channels=None,
                  dropout_prob=dropout)
        return DenseNet(**kw), JaxDenseNet(**kw), 32
    if name == "tinycnn":
        kw = dict(in_channels=2, out_channels=2, feature_channels=12,
                  dropout_prob=dropout)
        return (TinyCNN(**kw, dtype=dtype),
                JaxTinyCNN(**kw, dtype=None if dtype is None
                           else jnp.bfloat16), 16)
    if name == "seresnet50":
        return (SEResNet50(in_channels=2, num_classes=2),
                JaxSEResNet50(in_channels=2, num_classes=2), 16)
    return (ResNet3D18(in_channels=2, num_classes=2, dropout_prob=dropout),
            JaxResNet3D18(num_classes=2, dropout_prob=dropout), 16)


def _weights(port, seed=1):
    """Numpy-drawn weights in the JAX key scheme, loaded into ``port``."""
    torch.manual_seed(0)
    flat = randomise(to_jax_flat(port.state_dict()), seed=seed)
    load_jax_npz(port, flat)
    return flat


def _image(seed, batch, side):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, side, side, side, 2)).astype(np.float32)


def _run_jax(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimisation level
    0: the same operations, compiled in about 2/3 of the time (the
    DenseNets' compile is most of this file's time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    limit = tol * max(1.0, np.abs(want).max())
    print(f"{what}: max|port - JAX| {err:.2e} (limit {limit:.1e})")
    assert got.shape == want.shape and err <= limit, (what, err, limit)


# ------------------------------------------------- full width, no compute --

def _jax_shapes(model, sample):
    v = jax.eval_shape(lambda x: model.init(jax.random.key(0), x), sample)
    return {f"{col}/" + "/".join(k): tuple(a.shape)
            for col in ("params", "batch_stats")
            for k, a in flatten_dict(dict(v.get(col, {}))).items()}


@pytest.mark.parametrize("name", NAMES)
def test_registry_keys_and_shapes_match_jax_at_full_width(name):
    jcfg, cfg = JaxConfig(), Config()
    jcfg.image_model.name = cfg.image_model.name = name
    want = _jax_shapes(jax_build_model(jcfg, True, False, False, False),
                       jax.ShapeDtypeStruct((1, 64, 64, 64, 2), jnp.float32))
    with torch.device("meta"):
        model = build_model(cfg, True, False, False, False)
    got = {k: tuple(v.shape) for k, v in to_jax_flat(
        {k: torch.empty(v.shape) for k, v in model.state_dict().items()}
    ).items()}
    assert got == want


# ------------------------------------------------------- small, computed --

@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name):
    port, jmodel, side = _small(name)
    flat = _weights(port)
    x = _image(2, 2, side)
    want = _run_jax(lambda v, x: jmodel.apply(v, x, train=False),
                    jax_variables(flat), jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _close(got, want, EVAL_TOL, f"{name} eval")


@pytest.mark.parametrize("name", sorted(TRAIN_TOL))
def test_train_forward_and_running_stats_match_jax(name):
    port, jmodel, side = _small(name)
    flat = _weights(port)
    x = _image(3, 8, side)
    out, upd = _run_jax(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]), jax_variables(flat),
        jnp.asarray(x))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    _close(got, out, TRAIN_TOL[name], f"{name} train")
    stats = to_jax_flat(port.state_dict())
    for key, want in jax_flat({"batch_stats": upd["batch_stats"]}).items():
        _close(stats[key], want, TRAIN_TOL[name], f"{name} {key}")


@pytest.mark.parametrize("name", NAMES)
def test_to_jax_flat_round_trip(name):
    port, _, _ = _small(name)
    flat = _weights(port)
    back = to_jax_flat(from_jax_flat(flat))
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


@pytest.mark.parametrize("name", NAMES)
def test_each_family_takes_a_masked_superstep(name):
    """survival_train_superstep on the image-only model (A = 2 of B = 4,
    the second microbatch ragged, augmentation and dropout 0.2 from the
    state's generator): a finite loss, finite gradients, (A, B, 2)
    predictions."""
    port, _, side = _small(name, dropout=0.2)
    state = create_train_state(port, *make_optimizer(
        port.parameters(), 1e-3, 2, 2), seed=0)
    rng = np.random.default_rng(4)
    image = torch.from_numpy((rng.normal(size=(2, 4) + (side,) * 3 + (2,))
                              ** 2 * 500).astype(np.float32))
    events = torch.from_numpy((rng.random((2, 4, 2)) < 0.7)
                              .astype(np.float32))
    durations = torch.from_numpy(rng.integers(1, 9, (2, 4, 2))
                                 .astype(np.float32))
    mask = torch.tensor([[1.0] * 4, [1.0, 1.0, 0.0, 0.0]])
    aux = survival_train_superstep(state, image, events, durations,
                                   mask=mask)
    assert aux["preds"].shape == (2, 4, 2)
    assert torch.isfinite(aux["loss"])
    assert all(torch.isfinite(p.grad).all() for p in port.parameters())


@pytest.mark.parametrize("name", ["tinycnn", "monaidensenet", "seresnet50",
                                  "r3d_18"])
def test_each_family_exports_and_serves(name, tmp_path):
    """The registry's model at full width (32^3 for the DenseNet, 16^3 for
    the others) exports and answers a batch of 3 on the CPU as the model
    does."""
    cfg = Config()
    cfg.image_model.name = name
    cfg.image_model.spatial_size = [32 if name in BLOCKS else 16] * 3
    torch.manual_seed(0)
    model = build_model(cfg, True, False, False, False)
    _weights(model)
    path = str(tmp_path / "model.pt")
    export_forward(model, model_spec(cfg, True, False, False, False), path)
    served = ServingModel(path, device="cpu")
    side = cfg.image_model.spatial_size[0]
    raw = (_image(5, 3, side) ** 2 * 500).astype(np.float32)
    got = served(raw)
    from mmnn_sts_torch.ops.augment import eval_transform_batch
    with torch.no_grad():
        want = model.eval()(eval_transform_batch(torch.from_numpy(raw)))
    assert got.shape == (3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)


def test_tinycnn_in_bf16_matches_jax():
    """TinyCNN in bfloat16 (every convolution, BatchNorm and dense layer
    returning bfloat16) against the JAX bfloat16 model compiled without
    XLA's excess precision, held as tests/test_torch_bf16.py holds the
    DenseNet (``check_against_jax``: within 4 x the distance of JAX's
    default build, carrying bfloat16's error, within half of it)."""
    from test_torch_bf16 import assert_bf16, bf16_at_cast_points

    port, _, side = _small("tinycnn", dtype=torch.bfloat16)
    flat = _weights(port)
    x = jnp.asarray(_image(6, 4, side))
    variables = jax_variables(flat)
    paths = {}
    for path, (dtype, _) in PATHS.items():
        jmodel = JaxTinyCNN(in_channels=2, out_channels=2,
                            feature_channels=12, dropout_prob=0.0,
                            dtype=dtype)
        paths[path] = call(path, jax.jit(
            lambda v, x, m=jmodel: m.apply(v, x, train=False)), variables, x)
    seen = bf16_at_cast_points(port)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(np.array(x)))
    assert out.dtype == torch.bfloat16
    assert_bf16(seen)
    check_against_jax("TinyCNN bf16 eval logits", out.float(), paths)


def _tiny_multimodal_pair():
    kw = dict(in_channels=2, out_channels=None, feature_channels=12,
              dropout_prob=0.0)
    port = MultiModalModel(TinyCNN(**kw), num_clinical_inputs=11,
                           num_classes=2, num_features=12, blend=True,
                           clinical_dropout_prob=0.0)
    jmodel = JaxMultiModal(image_model=JaxTinyCNN(**{
        **kw, "out_channels": 2}), num_clinical_inputs=11, num_classes=2,
        num_features=12, blend=True, clinical_dropout_prob=0.0)
    flat = _weights(port)
    return port, jmodel, flat


def test_tinycnn_multimodal_blend_matches_jax():
    port, jmodel, flat = _tiny_multimodal_pair()
    rng = np.random.default_rng(8)
    inputs = {"image": _image(8, 2, 16),
              "clinical": rng.normal(size=(2, 11)).astype(np.float32)}
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax_variables(flat), {k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got = port.eval()({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.shape == (3, 2, 2)
    _close(got, want, EVAL_TOL, "tinycnn multimodal blend eval")


def test_tinycnn_gradcam_matches_jax():
    """TinyCNN's Grad-CAM target is conv5's output before its BatchNorm:
    the multimodal blend model's maps at 24^3 (conv5 at 14^3) as JAX's
    ``attention_maps`` draws them."""
    port, jmodel, flat = _tiny_multimodal_pair()
    rng = np.random.default_rng(9)
    inputs = {"image": (_image(9, 1, 24) ** 2).astype(np.float32),
              "clinical": rng.normal(size=(1, 11)).astype(np.float32)}
    want = jax_attention_maps(jmodel.apply, jax_variables(flat),
                              {k: jnp.asarray(v) for k, v in inputs.items()},
                              2, blend=True)
    got = attention_maps(port.eval(), {k: torch.from_numpy(v)
                                       for k, v in inputs.items()},
                         2, blend=True)
    assert got.shape == (2, 24, 24, 24)
    _close(got, want, 1e-4, "tinycnn Grad-CAM maps")


@pytest.mark.parametrize("name", ["seresnet50", "r3d_18"])
def test_gradcam_of_a_family_jax_cannot_draw_raises(name):
    port, _, side = _small(name)
    image = torch.from_numpy(_image(10, 1, side))
    with pytest.raises(ConfigurationError, match="--no_gradcam"):
        attention_maps(port.eval(), image, 2)


@pytest.mark.parametrize("name", ["seresnet50", "r3d_18", "densenet201",
                                  "monaidensenet"])
def test_multimodal_needs_a_compatible_family(name):
    """As the JAX registry (registry.py:152-157): the same error type and
    message, whose list of families also names the port's ``swinvit``
    (which has no JAX model)."""
    jcfg, cfg = JaxConfig(), Config()
    jcfg.image_model.name = cfg.image_model.name = name
    messages = []
    for build, c, error in ((jax_build_model, jcfg, Exception),
                            (build_model, cfg, ConfigurationError)):
        with pytest.raises(error) as info:
            with torch.device("meta"):
                build(c, True, True, False, True)
        messages.append(str(info.value))
    jax_list = "'tinydensenet' or 'densenet121'"
    assert jax_list in messages[0] and "'tinycnn'" in messages[1]
    assert messages[1] == messages[0].replace(
        jax_list, "'tinydensenet', 'densenet121' or 'swinvit'")


def test_registry_names_follow_the_jax_prefix_rule():
    cfg = Config()
    built = {}
    for name in ("TinyCNN_v2", "r3d18", "R3D_18", "densenet264x",
                 "seresnet50-se", "monaidensenet"):
        cfg.image_model.name = name
        with torch.device("meta"):
            built[name] = type(build_model(cfg, True, False, False, False))
    assert built == {"TinyCNN_v2": TinyCNN, "r3d18": ResNet3D18,
                     "R3D_18": ResNet3D18, "densenet264x": DenseNet,
                     "seresnet50-se": SEResNet50, "monaidensenet": DenseNet}


# ------------------------------------------------------------------ CLI --

def test_image_only_cli_run_trains_a_tinycnn_jax_loads(tmp_path):
    """``--images --survival --split`` with tinycnn for 2 epochs on the
    CPU: the best ``.npz`` loads into the JAX TinyCNN, whose eval outputs
    are the port model's on the same weights."""
    paths, _ = make_full_cohort(str(tmp_path / "cohort"), n=23)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({
        "Data": {"data_loc": paths["clinical"], "image_loc": paths["root"],
                 "key_loc": paths["key"]},
        "ImageModel": {"name": "tinycnn", "spatial_size": [16] * 3},
        "Hyperparameters": {"train_batch_size": 4, "seed": 3}}))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = port_main(["--images", "--survival", "--split", "--epochs", "2",
                        "--config", str(config), "--output_path", "out",
                        "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    rows = [json.loads(r) for r in
            (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    with np.load(tmp_path / "out" / "best_surv_model.npz") as data:
        flat = {k: data[k] for k in data.files}
    jcfg = JaxConfig()
    jcfg.image_model.name = "tinycnn"
    jmodel = jax_build_model(jcfg, True, False, False, False)
    x = _image(11, 3, 16)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax_variables(flat), jnp.asarray(x))
    cfg = Config()
    cfg.image_model.name = "tinycnn"
    port = build_model(cfg, True, False, False, False)
    load_jax_npz(port, flat)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _close(got, want, EVAL_TOL, "tinycnn trained by the CLI, eval")


def test_unknown_name_and_2d_raise():
    """An unknown name raises; with ``spatial_dims: 2`` tinycnn builds and
    answers a (N, H, W, C) batch, and r3d_18 stays 3D (the JAX registry
    passes it no ``spatial_dims``)."""
    cfg = Config()
    cfg.image_model.name = "vit3d"
    with pytest.raises(ConfigurationError, match="not recognized"):
        build_model(cfg, True, False, False, False)
    cfg.image_model.spatial_dims = 2
    cfg.image_model.name = "tinycnn"
    model = build_model(cfg, True, False, False, False).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(_image(12, 2, 16)[:, 0]))
    assert out.shape == (2, cfg.image_model.num_classes)
    assert torch.isfinite(out).all()
    cfg.image_model.name = "r3d_18"
    with torch.device("meta"):
        r3d = build_model(cfg, True, False, False, False)
    assert r3d.stem_conv.weight.dim() == 5
