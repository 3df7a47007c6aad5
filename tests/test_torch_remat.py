"""TPU.remat in the port: ``torch.utils.checkpoint`` around each DenseNet
dense layer and transition in train mode (``models/common.remat_call``),
case for case as the JAX package's tests/test_remat.py pins its
``nn.remat``: the parameter tree is the same, the eval forward is the same,
and in train mode with dropout 0.2 the output, every weight gradient and
every running statistic are the unwrapped model's, also through the real
blended survival superstep with augmentation and dropout drawn from the
state's generator.

Two things the recompute must not do, each checked: fold its batch
statistics into the running ones a second time, and draw other dropout
masks (``torch.utils.checkpoint`` restores the default generators only, not
the explicit one the dropouts draw from). Also: every wrapped bottleneck's
forward runs twice, so the fused op is called 22 + 21 times a microbatch
of the remat TinyDenseNet (the Grad-CAM target layer stays unwrapped), and
``TPU.remat: true`` parses and reaches the model. Everything runs on the
CPU in the same order of operations, so the results are held bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from mmnn_sts_torch.config import Config, parse_config
from mmnn_sts_torch.models import build_model
from mmnn_sts_torch.models.densenet import tiny_densenet
from mmnn_sts_torch.ops import fused_dense
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import survival_train_superstep

torch.set_num_threads(1)

KW = dict(in_channels=2, out_channels=2, feature_channels=12,
          dropout_prob=0.2)
LAYERS = 6 + 12 + 4  # TinyDenseNet's dense layers


def _pair(**kw):
    """(plain, remat) TinyDenseNets with the same weights."""
    torch.manual_seed(0)
    base = tiny_densenet(**KW, **kw)
    remat = tiny_densenet(remat=True, **KW, **kw)
    remat.load_state_dict(base.state_dict())
    return base, remat


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.normal(size=(2, 16, 16, 16, 2))
                            .astype(np.float32))


def test_remat_param_tree_identical():
    """remat renames and reshapes nothing: checkpoints are interchangeable
    between the two settings."""
    base, remat = _pair()
    assert {k: v.shape for k, v in base.state_dict().items()} == \
        {k: v.shape for k, v in remat.state_dict().items()}


def test_remat_eval_forward_identical(image):
    base, remat = _pair()
    with torch.no_grad():
        torch.testing.assert_close(remat.eval()(image), base.eval()(image),
                                   rtol=0, atol=0)


def _train_pass(model, image):
    """A train-mode forward with dropout 0.2 from a fixed generator and the
    backward of sum(out^2): (loss, gradients, running statistics, the
    generator's state after the backward)."""
    gen = torch.Generator().manual_seed(3)
    out = model.train()(image, generator=gen)
    loss = out.square().sum()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    return loss.detach(), grads, stats, gen.get_state()


def test_remat_train_grads_and_stats_match(image):
    """Same weights, same dropout generator: the loss, every weight
    gradient and the updated running statistics are the same bits, and
    the generator ends where the unwrapped model leaves it."""
    base, remat = _pair()
    l1, g1, s1, gen1 = _train_pass(base, image)
    l2, g2, s2, gen2 = _train_pass(remat, image)
    torch.testing.assert_close(l2, l1, rtol=0, atol=0)
    assert g1.keys() == g2.keys() and s1.keys() == s2.keys()
    for name in g1:
        torch.testing.assert_close(g2[name], g1[name], rtol=0, atol=0,
                                   msg=name)
    for name in s1:
        torch.testing.assert_close(s2[name], s1[name], rtol=0, atol=0,
                                   msg=name)
    assert torch.equal(gen1, gen2)


def test_remat_recompute_draws_the_forwards_masks(image):
    """The dropout masks matter: a recompute that drew fresh masks (the
    generator not replayed) gives other gradients. A control that the test
    above can fail."""
    from mmnn_sts_torch.models import common

    base, remat = _pair()
    _, g1, _, _ = _train_pass(base, image)
    replay = common.remat_call

    def fresh_draws(fn, *args, generator=None):
        return replay(fn, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("mmnn_sts_torch.models.densenet.remat_call", fresh_draws)
        _, g2, _, _ = _train_pass(remat, image)
    assert any(not torch.equal(g1[n], g2[n]) for n in g1)


def _counting_op(calls):
    plain = fused_dense.fused_bn_relu_matmul

    def op(x, a, b, w):
        calls.append(tuple(x.shape))
        return plain(x, a, b, w)

    return op


def _superstep(remat: bool, calls):
    cfg = Config()
    cfg.image_model.name = "tinydensenet"
    cfg.image_model.spatial_size = [16] * 3
    cfg.image_model.dropout_prob = 0.2
    cfg.tpu.remat = remat
    torch.manual_seed(0)
    model = build_model(cfg, images=True, preop=True, postop=False,
                        blend=True)
    state = create_train_state(model, *make_optimizer(
        model.parameters(), 5e-4, 2, 10), seed=42)
    rng = np.random.default_rng(1)
    inputs = {"image": torch.from_numpy(
                  (rng.normal(size=(2, 2, 16, 16, 16, 2)) ** 2 * 500)
                  .astype(np.float32)),
              "clinical": torch.from_numpy(
                  rng.normal(size=(2, 2, 11)).astype(np.float32))}
    events = torch.from_numpy((rng.random((2, 2, 2)) < 0.7)
                              .astype(np.float32))
    durations = torch.from_numpy(rng.integers(1, 500, (2, 2, 2))
                                 .astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_dense, "fused_bn_relu_matmul", _counting_op(calls))
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, augment=True)
    return aux, state


def test_remat_through_train_superstep():
    """The blended survival superstep (two microbatches, augmentation and
    dropout 0.2 from the state's generator) under remat: the loss, the
    predictions, the updated parameters and running statistics and the
    generator's state are the unwrapped run's; the fused op runs 22 + 21
    times a microbatch, not 22."""
    calls = {False: [], True: []}
    (aux1, st1), (aux2, st2) = (_superstep(r, calls[r]) for r in (False,
                                                                   True))
    assert st2.model.image_model.remat and not st1.model.image_model.remat
    assert len(calls[False]) == 2 * LAYERS
    assert len(calls[True]) == 2 * (2 * LAYERS - 1)
    torch.testing.assert_close(aux2["loss"], aux1["loss"], rtol=0, atol=0)
    torch.testing.assert_close(aux2["preds"], aux1["preds"], rtol=0, atol=0)
    sd1, sd2 = st1.model.state_dict(), st2.model.state_dict()
    for name in sd1:
        torch.testing.assert_close(sd2[name], sd1[name], rtol=0, atol=0,
                                   msg=name)
    assert torch.equal(st1.generator.get_state(), st2.generator.get_state())


def test_remat_parses_and_reaches_the_model(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"ImageModel": {"name": "densenet201"},
                                "TPU": {"remat": True}}))
    cfg = parse_config(str(path))
    assert cfg.tpu.remat
    with torch.device("meta"):
        model = build_model(cfg, images=True, preop=False, postop=False,
                            blend=False)
    assert model.remat and model.block_config == (6, 12, 48, 32)
