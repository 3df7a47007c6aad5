"""``ImageModel.spatial_dims: 2``: every 2D-capable family of the port
(``models/common.py``'s 2D layers, ``densenet.py``, ``tinycnn.py``,
``seresnet.py``, ``registry.py``) held against the JAX models fed the same
(N, H, W, C) inputs on the same weights, carried by ``convert.py``.

* The eval forward of every family at a small size: tinycnn and
  seresnet50 at their own widths, the DenseNets narrow (``init_features``
  8, ``growth_rate`` 4) with each registry name's blocks, at 64^2 (their
  last block at 2^2).
* In train mode (dropout 0), for tinycnn, seresnet50 and the multimodal
  blend model around a narrow DenseNet121: the output, every running
  statistic after the update, and the gradient of a fixed linear function
  of the output with respect to every parameter.
* 2D Grad-CAM against JAX's ``attention_maps`` (bilinear: JAX's
  ``method="trilinear"`` is linear in any number of dimensions) at 64^2,
  where the DenseNet's last block is 2^2 (at 1^2 every map is 0).
* ``to_jax_flat(from_jax_flat(x)) == x`` for 2D models in both bottleneck
  layouts (4-D kernels transposed both ways); the 2D max pool's
  fixed-order backward equal to torch's CPU backward; the 2D bfloat16
  average pool equal to flax's, one rounded add per window element; the
  bottleneck kernel's launch plans at the 2D DenseNets' shapes, M = B x H
  x W.

Tolerances, as the 3D twins' (tests/test_torch_model_families.py): eval
1e-5 and train 1e-5 (tinycnn) or 1e-3 (the BatchNorm-deep models) of
max(1, max |JAX|); gradients, in units of the model's largest JAX
gradient (a bias that a train-mode BatchNorm removes has a gradient of
roundoff alone), within 1e-3 or twice the distance JAX's own move under a
one-ulp scaling of the input, computed in the test (seresnet50's stem:
7.7e-2); maps 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.models.seresnet import SEResNet50 as JaxSEResNet50
from mmnn_sts_tpu.models.tinycnn import TinyCNN as JaxTinyCNN
from mmnn_sts_tpu.ops.gradcam import attention_maps as jax_attention_maps
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.convert import from_jax_flat, to_jax_flat
from mmnn_sts_torch.models import build_model
from mmnn_sts_torch.models.common import _MaxPool, avg_pool
from mmnn_sts_torch.models.densenet import DenseNet, bottleneck_shapes
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.models.seresnet import SEResNet50
from mmnn_sts_torch.models.tinycnn import TinyCNN
from mmnn_sts_torch.ops import fused_dense
from mmnn_sts_torch.ops.gradcam import attention_maps
from test_torch_convert import jax_flat, jax_variables
from test_torch_model_families import (
    BLOCKS, NARROW, _close, _run_jax, _weights)

torch.set_num_threads(1)

EVAL_TOL = 1e-5
TRAIN_TOL = {"tinycnn": 1e-5, "seresnet50": 1e-3, "multimodal": 1e-3}
# the port's gradients lie within GRAD_CONTROL x the distance that scaling
# the input by 1 + 2^-22 moves JAX's own (up to 7.7e-2 of the largest
# gradient: ReLUs and max pools flip at roundoff), or within GRAD_FLOOR
GRAD_CONTROL, GRAD_FLOOR = 2.0, 1e-3
MAP_TOL = 1e-4
DENSE_BLOCKS = {"densenet121": (6, 12, 24, 16), **BLOCKS}


def _pair(name, dropout=0.0, blocks=(6, 12, 24, 16)):
    """(port model, JAX model, input side) of ``name`` in 2D; "multimodal"
    is the blend model around a narrow DenseNet of ``blocks``. The port's
    init (the kernels ``_weights`` keeps) is drawn from seed 0."""
    torch.manual_seed(0)
    if name in DENSE_BLOCKS:
        kw = dict(NARROW, block_config=DENSE_BLOCKS[name],
                  feature_channels=12 if name == "densenet121" else None,
                  dropout_prob=dropout, spatial_dims=2)
        return DenseNet(**kw), JaxDenseNet(**kw), 64
    if name == "tinycnn":
        kw = dict(in_channels=2, out_channels=2, feature_channels=12,
                  dropout_prob=dropout, spatial_dims=2)
        return TinyCNN(**kw), JaxTinyCNN(**kw), 24
    if name == "seresnet50":
        kw = dict(in_channels=2, num_classes=2, spatial_dims=2)
        return SEResNet50(**kw), JaxSEResNet50(**kw), 32
    kw = dict(NARROW, out_channels=None, feature_channels=12,
              dropout_prob=dropout, spatial_dims=2, block_config=blocks)
    port = MultiModalModel(DenseNet(**kw), num_clinical_inputs=11,
                           num_classes=2, num_features=12, blend=True,
                           clinical_dropout_prob=0.0)
    jmodel = JaxMultiModal(image_model=JaxDenseNet(**{
        **kw, "out_channels": 2}), num_clinical_inputs=11, num_classes=2,
        num_features=12, blend=True, clinical_dropout_prob=0.0)
    return port, jmodel, 64


def _inputs(name, seed, batch, side):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(batch, side, side, 2)).astype(np.float32)
    if name != "multimodal":
        return image
    return {"image": image,
            "clinical": rng.normal(size=(batch, 11)).astype(np.float32)}


def _jnp(x):
    return ({k: jnp.asarray(v) for k, v in x.items()}
            if isinstance(x, dict) else jnp.asarray(x))


def _torch(x):
    return ({k: torch.from_numpy(v) for k, v in x.items()}
            if isinstance(x, dict) else torch.from_numpy(x))


@pytest.mark.parametrize("name", ["tinycnn", "seresnet50", *DENSE_BLOCKS])
def test_planar_eval_forward_matches_jax(name):
    port, jmodel, side = _pair(name)
    flat = _weights(port)
    x = _inputs(name, 2, 2, side)
    want = _run_jax(lambda v, x: jmodel.apply(v, x, train=False),
                    jax_variables(flat), _jnp(x))
    with torch.no_grad():
        got = port.eval()(_torch(x))
    _close(got, want, EVAL_TOL, f"{name} 2D eval")


@pytest.mark.parametrize("name", sorted(TRAIN_TOL))
def test_planar_train_forward_stats_and_gradients_match_jax(name):
    """Train mode: the output, the running statistics after the update and
    d(sum(out * c))/d(parameter) for a fixed random c."""
    port, jmodel, side = _pair(name)
    flat = _weights(port)
    x = _inputs(name, 3, 4, side)
    variables = jax_variables(flat)
    with torch.no_grad():
        shape = tuple(port.train()(_torch(x)).shape)
    cot = np.random.default_rng(4).normal(size=shape).astype(np.float32)

    def loss(params, x):
        out, upd = jmodel.apply({**variables, "params": params}, x,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    args = (variables["params"], _jnp(x))
    compiled = fn.lower(*args).compile({"xla_backend_optimization_level": 0})
    (_, (out, upd)), grads = compiled(*args)
    _weights(port)  # the same weights again (the forward above moved
    # the running statistics)
    got = port.train()(_torch(x))
    (got * torch.from_numpy(cot)).sum().backward()
    tol = TRAIN_TOL[name]
    _close(got.detach(), out, tol, f"{name} 2D train")
    stats = to_jax_flat(port.state_dict())
    for key, want in jax_flat({"batch_stats": upd["batch_stats"]}).items():
        _close(stats[key], want, tol, f"{name} {key}")
    params = dict(port.named_parameters())
    port_grads = to_jax_flat({n: params[n].grad if n in params else v
                              for n, v in port.state_dict().items()})
    want_grads = jax_flat({"params": grads})
    port_grads = {k: v for k, v in port_grads.items() if k in want_grads}
    assert port_grads.keys() == want_grads.keys()
    # the control: JAX's own gradients on the input scaled by 1 + 2^-22
    ulp = x if not isinstance(x, dict) else x["image"]
    ulp = (ulp * np.float32(1 + 2**-22)).astype(np.float32)
    control = jax_flat({"params": compiled(
        variables["params"], _jnp({**x, "image": ulp}
                                   if isinstance(x, dict) else ulp))[1]})

    def worst(got):
        # each tensor against the model's largest gradient: a bias that a
        # train-mode BatchNorm removes has a gradient of roundoff alone
        scale = max(float(np.abs(w).max()) for w in want_grads.values())
        return max((float(np.abs(got[k] - w).max()) / scale, k)
                   for k, w in want_grads.items())

    err, control_err = worst(port_grads), worst(control)
    print(f"{name} 2D gradients: worst error {err[0]:.2e} ({err[1]}); the "
          f"one-ulp control's {control_err[0]:.2e} ({control_err[1]})")
    assert err[0] <= max(GRAD_FLOOR, GRAD_CONTROL * control_err[0]), (
        err, control_err)


@pytest.mark.parametrize("name", ["multimodal", "tinycnn"])
def test_planar_gradcam_matches_jax(name):
    """The maps at 64^2 as JAX's ``attention_maps`` draws them, in [0, 1]:
    TinyCNN's, and the blend model's (head 0) around a narrow TinyDenseNet
    (blocks 6, 12, 4; its last block at 4^2)."""
    port, jmodel, _ = _pair(name, blocks=(6, 12, 4))
    flat = _weights(port)
    inputs = _inputs(name, 9, 1, 64)
    if name == "tinycnn":
        inputs = (inputs ** 2).astype(np.float32)
    blend = name == "multimodal"
    want = jax_attention_maps(jmodel.apply, jax_variables(flat),
                              _jnp(inputs), 2, blend=blend)
    got = attention_maps(port.eval(), _torch(inputs), 2, blend=blend)
    assert got.shape == (2, 64, 64)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert float(got.max()) > 0.5
    _close(got, want, MAP_TOL, f"{name} 2D Grad-CAM maps")


@pytest.mark.parametrize("layout", ["unfused", "fused"])
@pytest.mark.parametrize("name", ["multimodal", "seresnet50", "tinycnn"])
def test_4d_kernels_round_trip(name, layout):
    port, _, _ = _pair(name)
    flat = to_jax_flat(port.state_dict(), layout)
    kernels = [k for k, v in flat.items() if k.endswith("/kernel")
               and v.ndim == 4]
    assert kernels
    if name == "multimodal":
        assert ("params/image_model/block1_layer1/conv1/kernel" in flat) == (
            layout == "unfused")
    back = to_jax_flat(from_jax_flat(flat), layout)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    sd = from_jax_flat(flat)
    for key, value in port.state_dict().items():
        assert torch.equal(sd[key], value.float()), key


def test_2d_max_pool_backward_is_torchs_cpu_order():
    torch.manual_seed(0)
    for shape in [(2, 3, 9, 10), (2, 4, 16, 16)]:
        x = torch.randn(shape).contiguous(memory_format=torch.channels_last)
        x.requires_grad_(True)
        out = _MaxPool.apply(x, 3, 2, 1)
        g = torch.randn_like(out)
        (got,) = torch.autograd.grad(out, x, g)
        (want,) = torch.autograd.grad(
            torch.nn.functional.max_pool2d(x, 3, 2, 1), x, g)
        assert torch.equal(got, want)


def test_2d_bf16_avg_pool_is_flaxs():
    x = np.random.default_rng(5).normal(size=(2, 8, 6, 3)).astype(np.float32)
    want = fnn.avg_pool(jnp.asarray(x, jnp.bfloat16), (2, 2), strides=(2, 2),
                        padding="VALID")
    got = avg_pool(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                   2, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("name", sorted(DENSE_BLOCKS))
@pytest.mark.parametrize("side", [64, 256])
def test_2d_bottleneck_shapes_have_launch_plans(name, side):
    """Every bottleneck of the registry's 2D DenseNet at batch 8: M = 8 x
    (side / 4 / 2^block)^2, and both kernels' plans fit the card (the
    tile one of the kernel's, the split within ``max_split``)."""
    cfg = Config()
    cfg.image_model.name = name
    cfg.image_model.spatial_dims = 2
    with torch.device("meta"):
        model = build_model(cfg, True, False, False, False)
    shapes = bottleneck_shapes(model, 8, side)
    assert len(shapes) == sum(DENSE_BLOCKS[name])
    for block, m, k in shapes:
        assert m == 8 * (side // 4 >> (block - 1)) ** 2
        for dtype in (torch.float32, torch.bfloat16):
            bm, bn, split = fused_dense.launch_plan(m, k, 128, 132, dtype)
            assert (bm, bn) in fused_dense.plan_tiles(dtype)
            assert 1 <= split <= fused_dense.max_split(k, dtype)
