"""mmnn_sts_torch.convert: the weight bridge from the JAX package's flat
``.npz`` checkpoints (train/checkpoint.save_params_npz) to the port's
``state_dict`` and back, for both DenseNet bottleneck layouts.

Also home of the small JAX <-> numpy helpers the other port tests share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.train.checkpoint import save_params_npz
from mmnn_sts_torch.convert import from_jax_flat, load_jax_npz, to_jax_flat
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.multimodal import MultiModalModel

torch.set_num_threads(1)

NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16, bn_size=2,
              feature_channels=4, in_channels=2, out_channels=2)


def jax_flat(variables) -> dict:
    """flax variables -> the flat save_params_npz key scheme."""
    return {
        f"{col}/" + "/".join(k): np.asarray(v)
        for col in ("params", "batch_stats")
        for k, v in flatten_dict(dict(variables.get(col, {}))).items()
    }


def jax_variables(flat: dict) -> dict:
    """The flat key scheme -> flax variables."""
    out = {}
    for col in ("params", "batch_stats"):
        tree = {tuple(k.split("/")[1:]): jnp.asarray(v)
                for k, v in flat.items() if k.startswith(col + "/")}
        if tree:
            out[col] = unflatten_dict(tree)
    return out


def randomise(flat: dict, seed: int) -> dict:
    """Redraw BN affine/statistics and dense biases with numpy; keep the
    init kernels."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif leaf in ("bias", "mean"):
            v = rng.normal(0.0, 0.2, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _saved_checkpoint(tmp_path, use_pallas: bool) -> dict:
    """A JAX multimodal blend model's weights, written by the JAX package's
    own save_params_npz and read back as the flat key -> array dict."""
    image = JaxDenseNet(**NARROW, use_pallas=use_pallas,
                        pallas_interpret=use_pallas)
    model = JaxMultiModal(image_model=image, num_clinical_inputs=11,
                          num_classes=2, num_features=4, blend=True)
    sample = {"image": jnp.zeros((1, 16, 16, 16, 2)),
              "clinical": jnp.zeros((1, 11))}
    flat = randomise(jax_flat(model.init(jax.random.key(0), sample)), seed=7)
    variables = jax_variables(flat)
    path = tmp_path / "best_surv_model.npz"
    save_params_npz(str(path), variables["params"], variables["batch_stats"])
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _port_model():
    return MultiModalModel(DenseNet(**{**NARROW, "out_channels": None}), 11,
                           num_classes=2, num_features=4, blend=True)


@pytest.mark.parametrize("layout", ["unfused", "fused"])
def test_roundtrip_is_exact(tmp_path, layout):
    """JAX checkpoint -> port state_dict (strict load) -> JAX keys again:
    same keys, same shapes, same bits."""
    flat = _saved_checkpoint(tmp_path, use_pallas=layout == "fused")
    model = load_jax_npz(_port_model(), flat)
    back = to_jax_flat(model.state_dict(), layout=layout)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_both_layouts_load_into_one_port_module(tmp_path):
    """The unfused and fused spellings of the same weights give the same
    port state; the bottleneck is always the one fused module."""
    flat_u = _saved_checkpoint(tmp_path, use_pallas=False)
    sd_u = from_jax_flat(flat_u)
    sd_f = from_jax_flat(to_jax_flat(sd_u, layout="fused"))
    assert sorted(sd_u) == sorted(sd_f)
    assert all(torch.equal(sd_u[k], sd_f[k]) for k in sd_u)
    assert "image_model.block1_layer1.fused1.kernel" in sd_u
    assert sd_u["image_model.block1_layer1.fused1.kernel"].shape == (16, 16)
    assert sd_u["image_model.conv0.weight"].shape == (16, 2, 7, 7, 7)
    assert sd_u["output_head.weight"].shape == (2, 8)


def test_load_from_npz_path(tmp_path):
    flat = _saved_checkpoint(tmp_path, use_pallas=False)
    model = load_jax_npz(_port_model(), tmp_path / "best_surv_model.npz")
    assert torch.equal(model.state_dict()["clinical_model.bn_0.running_var"],
                       torch.from_numpy(
                           flat["batch_stats/clinical_model/bn_0/BatchNorm_0/var"]))


def test_bad_checkpoints_raise(tmp_path):
    with pytest.raises(ValueError, match="unrecognised"):
        from_jax_flat({"params/x/weird": np.zeros(3, np.float32)})
    flat = _saved_checkpoint(tmp_path, use_pallas=False)
    both = {**flat, **to_jax_flat(from_jax_flat(flat), layout="fused")}
    with pytest.raises(ValueError, match="two JAX keys"):
        from_jax_flat(both)
    del flat["params/output_head/bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_npz(_port_model(), flat)
