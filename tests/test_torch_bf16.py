"""bfloat16 compute (``TPU.compute_dtype: bfloat16``) in the port's modules,
held against the JAX package's bfloat16 path on the CPU: the fused
bottleneck op ``bn_relu_conv1x1`` with its gradients, a DenseLayer, the
registry's TinyDenseNet (``config.example.yaml``'s model family at 16^3)
in eval and train mode and as a servable, and the clinical MLP in eval and
train mode. tests/test_torch_bf16_steps.py holds the multimodal model, the
train, eval and classification steps and Grad-CAM.

Same weights (numpy draws carried across by ``convert.py``) and inputs on
both sides, dropout 0. The reference is the JAX bfloat16 path with its
bottleneck fused (the Pallas kernel in interpret mode, as
tests/test_pallas.py runs it), compiled without XLA's excess precision so
that it rounds at every cast point as the port does (``call``); by default
XLA may keep a fusion's intermediates in float32, and the jitted MLP then
lies 1.6e-2 from the same MLP run op by op. Each result is compared in
relative L2 (``check_against_jax``):

* within CONTROL_FACTOR = 4 x the control's distance. The control is the
  JAX package's default bfloat16 build: the bottleneck unfused
  (BatchNorm, ReLU, 1x1x1 convolution), compiled with XLA's defaults;
* at least half as far from the JAX float32 path as the reference is: the
  port carries bfloat16's error (a port in float32 lies ~1e-5 from
  float32 and fails);
* within half the reference's distance to float32, except where that
  cannot hold: TinyDenseNet's outputs after 22 layers. There the
  convolutions' float32 sums in another order round 1.7e-4 of the stem's
  outputs the other way; each layer multiplies the elements that differ
  by about ten, until by the second block a third of them differ by an
  ulp, and any such result lies as far from the reference as float32
  does (JAX's default build lies 1.06 x as far on the eval logits);
* and every convolution, dense layer, BatchNorm and fused bottleneck of
  the port returns bfloat16 (forward hooks).

Measured (CPU; port / control / float32 distance): the op and its
gradients 0 to 1.2e-7 / 0 to 3.1e-3 / 3.1e-3 to 2.0e-2; DenseLayer
3.4e-6 (eval), 3.3e-5 (train) / 2.4e-3, 2.0e-3 / 2.6e-3, 2.4e-3; MLP 0,
3.5e-8 / 1.7e-2, 1.9e-3 / 1.3e-2, 2.5e-3; TinyDenseNet logits 7.5e-3
(eval), 4.3e-2 (train), served 4.8e-3 / 6.0e-3, 5.3e-2, 2.1e-3 / 5.7e-3,
8.7e-2, 5.3e-3. Planted faults, each checked in a copy of the tree: the port
built in float32 and a BatchNorm that leaves its output in float32 both
fail this file and tests/test_torch_bf16_steps.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.models.densenet import DenseLayer as JaxDenseLayer
from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny_densenet
from mmnn_sts_tpu.models.mlp import MLP as JaxMLP
from mmnn_sts_tpu.ops.augment import eval_transform as jax_eval_transform
from mmnn_sts_tpu.ops.pallas.fused_dense import (
    bn_relu_conv1x1 as jax_bn_relu_conv1x1)
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
from mmnn_sts_torch.infer.export import (
    ServingModel, export_forward, model_spec)
from mmnn_sts_torch.models import build_model
from mmnn_sts_torch.models.common import BatchNorm, Conv3d, Linear
from mmnn_sts_torch.models.densenet import FusedBottleneck
from mmnn_sts_torch.models.mlp import MLP
from mmnn_sts_torch.ops.fused_dense import bn_relu_conv1x1
from test_torch_convert import jax_variables, randomise

torch.set_num_threads(1)

BF16 = jnp.bfloat16
EXACT = {"xla_allow_excess_precision": False}
CONTROL_FACTOR = 4.0
SIDE, B, P = 16, 4, 11
# the JAX paths: (compute dtype, bottleneck fused). "bf16" is the reference;
# "control" is the JAX package's default bfloat16 build (the bottleneck
# unfused, compiled with XLA's default excess precision, see ``call``)
PATHS = {"bf16": (BF16, True), "control": (BF16, False), "fp32": (None, False)}


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over every array of two equal trees."""
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    flat = [np.concatenate([np.asarray(t, np.float64).ravel() for t in ts])
            for ts in (got, want)]
    return float(np.linalg.norm(flat[0] - flat[1]) / np.linalg.norm(flat[1]))


def check_against_jax(what, port, jax_paths, within_half: bool = True):
    """The port's result against the JAX bfloat16 path's (``jax_paths``
    holds the three PATHS' results):

    * within CONTROL_FACTOR x the control's distance;
    * at least half as far from the float32 path as the JAX bfloat16 path
      is: it carries bfloat16's error (a port in float32 lies ~1e-5 away);
    * ``within_half``: within half the JAX bfloat16 path's distance to
      float32 (the module docstring says where this cannot hold).

    Returns the distances."""
    ref, fp32 = jax_paths["bf16"], jax_paths["fp32"]
    got = rel_l2(port, ref)
    ctrl = rel_l2(jax_paths["control"], ref)
    bf16_err, port_err = rel_l2(fp32, ref), rel_l2(port, fp32)
    print(f"{what}: port {got:.3e}, control {ctrl:.3e}, float32 "
          f"{bf16_err:.3e}, port to float32 {port_err:.3e}")
    assert got <= CONTROL_FACTOR * ctrl, (what, got, ctrl)
    assert port_err >= 0.5 * bf16_err, (what, port_err, bf16_err)
    if within_half:
        assert got <= 0.5 * bf16_err, (what, got, bf16_err)
    return got, ctrl, bf16_err, port_err


def bf16_at_cast_points(model):
    """Forward hooks that collect the dtype of every convolution, dense
    layer, BatchNorm and fused bottleneck output of ``model``; returns the
    list they fill."""
    seen = []
    for name, mod in model.named_modules():
        if isinstance(mod, (Conv3d, Linear, BatchNorm, FusedBottleneck)):
            mod.register_forward_hook(
                lambda m, args, out, name=name: seen.append((name, out.dtype)))
    return seen


def assert_bf16(seen):
    assert seen and all(d == torch.bfloat16 for _, d in seen), [
        (n, d) for n, d in seen if d != torch.bfloat16][:5]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _sub_flat(flat, prefix):
    """The keys of ``flat`` under module ``prefix``, with it stripped."""
    out = {}
    for key, v in flat.items():
        col, _, rest = key.partition("/")
        if rest.startswith(prefix + "/"):
            out[col + "/" + rest[len(prefix) + 1:]] = v
    return out


# --------------------------------------------------------------- the op --

def _op_operands(seed=0, m=96, cin=32, cout=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    bias = rng.normal(0.0, 0.2, cin).astype(np.float32)
    mean = rng.normal(0.0, 0.2, cin).astype(np.float32)
    var = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    w = (rng.normal(size=(cin, cout)) * (2.0 / cin) ** 0.5).astype(np.float32)
    g = rng.normal(size=(m, cout)).astype(np.float32)
    return x, scale, bias, mean, var, w, g


def _jax_op(path, x, scale, bias, mean, var, w, g):
    """(out, (dx, dscale, dbias, dw)) of the JAX path: the fused op (the
    Pallas kernel in interpret mode) or, unfused, BatchNorm in float32
    rounded to the compute dtype, ReLU and the product, as the unfused
    DenseLayer computes them. x arrives in the compute dtype, the float32
    w is cast at the call, so dw comes back float32."""
    dtype, fused = PATHS[path]
    dt = dtype or jnp.float32

    @jax.jit
    def f(x, scale, bias, w):
        if fused:
            return jax_bn_relu_conv1x1(x, scale, bias, mean, var,
                                       w.astype(dt), interpret=True)
        inv = jax.lax.rsqrt(var + 1e-5) * scale
        h = jax.nn.relu(((x.astype(jnp.float32) - mean) * inv + bias)
                        .astype(dt))
        return jnp.dot(h, w.astype(dt))

    @jax.jit
    def f_vjp(x, scale, bias, w, g):
        out, vjp = jax.vjp(f, x, scale, bias, w)
        return out, vjp(g.astype(out.dtype))

    return call(path, f_vjp, *(jnp.asarray(t) for t in (
        jnp.asarray(x).astype(dt), scale, bias, w, g)))


def test_bn_relu_conv1x1_and_its_gradients_in_bf16():
    x, scale, bias, mean, var, w, g = _op_operands()
    jax_paths = {p: _jax_op(p, x, scale, bias, mean, var, w, g)
                 for p in PATHS}
    leaves = [_t(x).bfloat16().requires_grad_()] + [
        _t(v).requires_grad_() for v in (scale, bias, w)]
    xb, s, b, w32 = leaves
    out = bn_relu_conv1x1(xb, s, b, _t(mean), _t(var), w32.bfloat16())
    out.backward(_t(g).bfloat16())
    assert out.dtype == xb.grad.dtype == torch.bfloat16
    assert s.grad.dtype == b.grad.dtype == w32.grad.dtype == torch.float32
    check_against_jax("bn_relu_conv1x1 forward", out.detach().float(),
                      {p: r[0] for p, r in jax_paths.items()})
    for i, name in enumerate(("dx", "dscale", "dbias", "dw")):
        check_against_jax(f"bn_relu_conv1x1 {name}", leaves[i].grad.float(),
                          {p: r[1][i] for p, r in jax_paths.items()})


# --------------------------------------- TinyDenseNet and the DenseLayer --

def _config():
    """config.example.yaml's model (tinydensenet in place of densenet121, at
    16^3, dropout 0) in bfloat16."""
    cfg = Config()
    cfg.image_model.name = "tinydensenet"
    cfg.image_model.spatial_size = [SIDE] * 3
    cfg.image_model.dropout_prob = 0.0
    cfg.tpu.compute_dtype = "bfloat16"
    return cfg


@pytest.fixture(scope="module")
def tiny():
    """The registry's TinyDenseNet in bfloat16 with numpy-drawn weights:
    (port model, fused flat, unfused flat)."""
    torch.manual_seed(0)
    model = build_model(_config(), images=True, preop=False, postop=False,
                        blend=False)
    flat = randomise(to_jax_flat(model.state_dict(), layout="fused"), seed=5)
    load_jax_npz(model, flat)
    return model, flat, to_jax_flat(model.state_dict(), layout="unfused")


def _jax_tiny(path):
    dtype, fused = PATHS[path]
    cfg = Config()
    return jax_tiny_densenet(
        in_channels=2, out_channels=cfg.image_model.num_classes,
        feature_channels=cfg.image_model.feature_layers, dropout_prob=0.0,
        dtype=dtype, use_pallas=fused, pallas_interpret=fused)


def call(path, jitted, *args, **static):
    """Call the jitted JAX function ``jitted`` for ``path``: the control as
    the JAX package compiles it; the others without XLA's excess precision,
    so that they round at every cast point, as the port and JAX run op by
    op do (by default XLA may keep a fusion's intermediates in float32)."""
    if path == "control":
        return jitted(*args, **static)
    return jitted.lower(*args, **static).compile(EXACT)(*args)


@functools.cache
def _jax_apply(model, train: bool, path: str):
    """(out, running statistics after the call, or None in eval mode)."""
    def run(variables, x):
        if train:
            out, upd = model.apply(variables, x, train=True,
                                   mutable=["batch_stats"])
            return out, upd["batch_stats"]
        return model.apply(variables, x, train=False), None
    return functools.partial(call, path, jax.jit(run))


def _image(seed):
    """Eval-transformed MRI-like volumes: what the served forward feeds."""
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=(B,) + (SIDE,) * 3 + (2,)) ** 2 * 500).astype(
        np.float32)
    return raw, np.asarray(jax.vmap(jax_eval_transform)(jnp.asarray(raw)))


def _stats(module):
    """A port module's running statistics as the JAX ``batch_stats`` tree
    (its leaves in the order of either JAX bottleneck layout's: ``fused1``
    and ``norm1`` both sort before ``norm2``)."""
    flat = to_jax_flat(module.state_dict(), layout="fused")
    return jax_variables({k: np.array(v) for k, v in flat.items()}
                         )["batch_stats"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tiny_densenet_in_bf16(tiny, train):
    model, flat, unfused = tiny
    _, image = _image(1)
    jax_paths, jax_stats = {}, {}
    for path in PATHS:
        variables = jax_variables(flat if PATHS[path][1] else unfused)
        jax_paths[path], jax_stats[path] = _jax_apply(
            _jax_tiny(path), train, path)(variables, image)
    port = build_model(_config(), True, False, False, False)
    load_jax_npz(port, flat)
    seen = bf16_at_cast_points(port)
    with torch.set_grad_enabled(train):
        out = port.train(train)(_t(image))
    assert out.dtype == torch.bfloat16
    assert_bf16(seen)
    check_against_jax(f"TinyDenseNet {'train' if train else 'eval'} logits",
                      out.detach().float(), jax_paths, within_half=False)
    if train:
        check_against_jax("TinyDenseNet running statistics", _stats(port),
                          jax_stats, within_half=False)


def test_tiny_densenet_servable_answers_float32_of_bf16(tiny, tmp_path):
    """The registry model exported from a bfloat16 config: the spec records
    the dtype, ServingModel rebuilds it in bfloat16 and answers float32
    values, held against the JAX eval forward of the same volumes."""
    model, flat, unfused = tiny
    raw, image = _image(2)
    spec = model_spec(_config(), True, False, False, False)
    assert spec["compute_dtype"] == "bfloat16"
    path = tmp_path / "model.pt"
    export_forward(model, spec, str(path))
    served = ServingModel(str(path), device="cpu")
    seen = bf16_at_cast_points(served.model)
    answer = served(raw[:3])
    assert answer.dtype == np.float32 and answer.shape == (3, 2)
    assert_bf16(seen)
    jax_paths = {p: _jax_apply(_jax_tiny(p), False, p)(
        jax_variables(flat if PATHS[p][1] else unfused), image)[0][:3]
        for p in PATHS}
    check_against_jax("TinyDenseNet served answer", answer, jax_paths,
                      within_half=False)


def _dense_layer_input(seed, cin):
    """A dense block's input: bfloat16, non-negative (a max pool of ReLUs)
    with some exact zeros."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(B, 4, 4, 4, cin)), 0.0)
    return np.asarray(jnp.asarray(x, BF16).astype(jnp.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dense_layer_in_bf16(tiny, train):
    model, flat, unfused = tiny
    layer = model.block1_layer2
    cin = layer.fused1.kernel.shape[0]
    x = _dense_layer_input(3, cin)
    jax_paths, jax_stats = {}, {}
    for path in PATHS:
        dtype, fused = PATHS[path]
        jlayer = JaxDenseLayer(3, 32, 4, 0.0, dtype=dtype, use_pallas=fused,
                               pallas_interpret=fused)
        variables = jax_variables(_sub_flat(flat if fused else unfused,
                                            "block1_layer2"))
        (jax_paths[path], _), jax_stats[path] = _jax_apply(
            jlayer, train, path)(
            variables, jnp.asarray(x).astype(dtype or jnp.float32))
    seen = bf16_at_cast_points(layer)
    layer.train(train)
    before = {k: v.clone() for k, v in layer.state_dict().items()}
    with torch.set_grad_enabled(train):
        out = layer(_t(x).bfloat16().permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d))
    stats = _stats(layer)
    layer.load_state_dict(before)
    assert out.dtype == torch.bfloat16
    assert_bf16(seen)
    check_against_jax(f"DenseLayer {'train' if train else 'eval'} output",
                      out.detach().float().permute(0, 2, 3, 4, 1), jax_paths)
    if train:
        check_against_jax("DenseLayer running statistics", stats, jax_stats)


# ------------------------------------------------------------------ MLP --

@pytest.fixture(scope="module")
def mlp():
    torch.manual_seed(1)
    model = MLP(in_channels=P, out_channels=2, feature_channels=12,
                dropout_prob=0.0, dtype=torch.bfloat16)
    flat = randomise(to_jax_flat(model.state_dict()), seed=6)
    load_jax_npz(model, flat)
    return model, flat


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mlp_in_bf16(mlp, train):
    """The MLP has no bottleneck: its control is the same JAX bfloat16 MLP
    compiled with XLA's defaults."""
    model, flat = mlp
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(B, P)) * 30).astype(np.float32)
    variables = jax_variables(flat)
    results = {}
    for path in PATHS:
        jmlp = JaxMLP(in_channels=P, out_channels=2, feature_channels=12,
                      dropout_prob=0.0, dtype=PATHS[path][0])
        out, stats = _jax_apply(jmlp, train, path)(variables, x)
        results[path] = [out] + ([stats] if train else [])
    seen = bf16_at_cast_points(model)
    model.train(train)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.set_grad_enabled(train):
        out = model(_t(x))
    got = [out.detach().float()] + ([_stats(model)] if train else [])
    model.load_state_dict(before)
    assert out.dtype == torch.bfloat16
    assert_bf16(seen)
    check_against_jax(f"MLP {'train' if train else 'eval'}", got, results)
