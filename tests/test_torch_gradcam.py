"""The port's Grad-CAM (``ops/gradcam.attention_maps``, the models'
``capture_gradcam`` path) and the attention-map export
(``data/nifti.save_attention_maps``) held against the JAX package's.

A narrow TinyDenseNet (blocks 6, 12, 4; growth 8, 16 initial features,
bottleneck width 16) at 32^3 x 2ch, whose last block is 2^3 (at 16^3 it is
1^3 and every map is 0 after the min shift), with the JAX init's weights
redrawn by ``randomise`` and carried across by ``convert.py``: the
multimodal blend model, the multimodal model without blending, and the
image-only model. Maps within 1e-4 absolute of JAX's (CPU; the JAX side
runs its unfused bottleneck, the port its fused op's plain version).

The trilinear resize is held against ``jax.image.resize`` at four
upsampling shapes (1e-6); the exported NIfTI files are byte-equal after
decompression (gzip's header holds a time), preds.txt byte for byte.
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.data.nifti import save_attention_maps as jax_save_maps
from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny_densenet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.ops.gradcam import attention_maps as jax_attention_maps
from mmnn_sts_torch.convert import load_jax_npz
from mmnn_sts_torch.data.nifti import save_attention_maps
from mmnn_sts_torch.models.densenet import tiny_densenet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.ops.gradcam import attention_maps, resize_trilinear
from test_torch_convert import jax_flat, jax_variables, randomise

torch.set_num_threads(1)

SIDE, P, C = 32, 11, 2
TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)
MAP_TOL = 1e-4
CASES = ("multimodal-blend", "multimodal", "image-only")


def _inputs(seed=0, batch=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(batch,) + (SIDE,) * 3 + (2,)
                                ).astype(np.float32),
            "clinical": rng.normal(size=(batch, P)).astype(np.float32)}


def _models(case):
    """(JAX model, its variables, port model, multimodal, blend)."""
    multimodal, blend = case != "image-only", case == "multimodal-blend"
    if multimodal:
        jmodel = JaxMultiModal(
            image_model=jax_tiny_densenet(**TINY, out_channels=C,
                                          dropout_prob=0.0),
            num_clinical_inputs=P, num_classes=C, num_features=4,
            blend=blend, clinical_dropout_prob=0.0)
        port = MultiModalModel(
            tiny_densenet(**TINY, out_channels=None, dropout_prob=0.0), P,
            num_classes=C, num_features=4, blend=blend,
            clinical_dropout_prob=0.0)
        sample = {k: jnp.asarray(v) for k, v in _inputs().items()}
    else:
        jmodel = jax_tiny_densenet(**TINY, out_channels=C, dropout_prob=0.0)
        port = tiny_densenet(**TINY, out_channels=C, dropout_prob=0.0)
        sample = jnp.asarray(_inputs()["image"])
    flat = randomise(jax_flat(jmodel.init(jax.random.key(0), sample)), seed=5)
    load_jax_npz(port, flat)
    return jmodel, jax_variables(flat), port.eval(), multimodal, blend


@pytest.fixture(scope="module", params=CASES)
def maps(request):
    jmodel, variables, port, multimodal, blend = _models(request.param)
    inputs = _inputs(seed=1)
    if not multimodal:
        inputs = inputs["image"]
    jin = ({k: jnp.asarray(v) for k, v in inputs.items()} if multimodal
           else jnp.asarray(inputs))
    want = np.asarray(jax_attention_maps(jmodel.apply, variables, jin,
                                         num_classes=C, blend=blend))
    tin = ({k: torch.from_numpy(v) for k, v in inputs.items()} if multimodal
           else torch.from_numpy(inputs))
    got = attention_maps(port, tin, num_classes=C, blend=blend)
    return dict(want=want, got=got, port=port, inputs=tin, blend=blend)


def test_attention_maps_match_jax(maps):
    got, want = maps["got"], maps["want"]
    assert got.shape == want.shape == (C,) + (SIDE,) * 3
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MAP_TOL)
    for cls in range(C):  # normalised before the resize
        assert want[cls].max() > 0.5
        assert got[cls].min() >= 0.0 and got[cls].max() <= 1.0
    assert not np.allclose(want[0], want[1])


def test_attention_maps_leave_no_gradients(maps):
    """The gradients are taken with respect to the activation alone: no
    parameter's ``.grad`` is written, and the maps hold no graph."""
    assert all(p.grad is None for p in maps["port"].parameters())
    assert not maps["got"].requires_grad


def test_capture_gradcam_returns_the_last_conv_output(maps):
    port, inputs = maps["port"], maps["inputs"]
    with torch.no_grad():
        plain = port(inputs)
        out, act = port(inputs, capture_gradcam=True)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    assert act.shape == (1, TINY["growth_rate"], 2, 2, 2)


def test_batch_size_guard():
    *_, port, _, blend = _models("multimodal-blend")
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(batch=2).items()}
    with pytest.raises(AssertionError, match="batch size 1"):
        attention_maps(port, inputs, num_classes=C, blend=blend)


@pytest.mark.parametrize("src,dst", [((2, 2, 2), (64, 64, 64)),
                                     ((2, 3, 1), (20, 30, 10)),
                                     ((4, 4, 2), (32, 32, 16)),
                                     ((3, 5, 2), (17, 23, 9))])
def test_resize_matches_jax_image_resize(src, dst):
    vol = np.random.default_rng(sum(src)).random(src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(vol), dst,
                                       method="trilinear"))
    got = resize_trilinear(torch.from_numpy(vol), dst).numpy()
    assert got.shape == dst
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("filename", ["preds.txt", "probabilities.txt"])
def test_save_attention_maps_writes_the_jax_files(tmp_path, filename):
    rng = np.random.default_rng(3)
    t1, t2 = (rng.normal(size=(6, 5, 4)).astype(np.float32) for _ in range(2))
    maps = rng.random((3, 6, 5, 4)).astype(np.float32)
    preds = np.array([-0.4441955089569092, 1e-7, 3.0], np.float32)
    args = (t1, t2, maps[0], preds)
    kw = dict(preds_filename=filename, extra_maps={1: maps[1], 2: maps[2]})
    jax_save_maps(str(tmp_path / "jax"), *args, **kw)
    save_attention_maps(str(tmp_path / "port"), *args, **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == sorted(
        ["t1image.nii.gz", "t2image.nii.gz", "att_map.nii.gz",
         "att_map_cls1.nii.gz", "att_map_cls2.nii.gz", filename])
    for name in names:
        read = gzip.open if name.endswith(".gz") else open
        with read(tmp_path / "jax" / name, "rb") as f:
            want = f.read()
        with read(tmp_path / "port" / name, "rb") as f:
            assert f.read() == want, name
    text = (tmp_path / "port" / filename).read_text()
    assert text == "".join(str(float(p)) for p in preds)  # no separator
