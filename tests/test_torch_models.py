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
    DenseLayer, DenseNet, FusedBottleneck, bottleneck_shapes, densenet121)
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
    (M, Cin) of every DenseNet121 bottleneck (densenet.bottleneck_shapes):
    those must be what the port's DenseNet121 feeds them, in order (checked
    at 32^3, half the served side length, to keep the CPU forward small)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    model = densenet121(in_channels=2, out_channels=None).eval()
    seen = []
    for mod in model.modules():
        if isinstance(mod, FusedBottleneck):
            assert tuple(mod.kernel.shape[1:]) == (chip_smoke.BOTTLENECK_OUT,)
            mod.register_forward_pre_hook(lambda m, args: seen.append(
                (args[0].shape[0] * args[0].shape[2:].numel(),
                 args[0].shape[1])))
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 32, 2), return_features=True)
    assert seen == [(m, cin) for _, m, cin in
                    bottleneck_shapes(model, 1, size=32)]
    assert len(bottleneck_shapes(model, 8)) == 58


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
    cfg = Config()
    cfg.image_model.name = "seresnet50"
    with pytest.raises(ConfigurationError, match="ROADMAP"):
        build_model(cfg, images=True, preop=False, postop=False, blend=False)
    cfg = Config()
    cfg.tpu.compute_dtype = "bfloat16"
    with pytest.raises(ConfigurationError, match="ROADMAP"):
        build_model(cfg, images=True, preop=True, postop=False, blend=True)


def test_train_mode_is_refused():
    """Train mode runs; what training still refuses is the random
    augmentation, which is not ported yet."""
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    model = MLP(in_channels=11, out_channels=2)
    state = create_train_state(model, *make_optimizer(model.parameters(),
                                                      1e-2, 1, 1))
    with pytest.raises(NotImplementedError, match="augmentation.*ROADMAP"):
        survival_train_superstep(state, torch.zeros(1, 4, 11),
                                 torch.ones(1, 4, 2), torch.ones(1, 4, 2),
                                 augment=True)
    assert state.step == 0
