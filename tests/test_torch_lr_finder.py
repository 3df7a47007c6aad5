"""The LR range test (``--lr_finder``, ``mmnn_sts_torch/train/lr_finder.py``)
held against the JAX package's (train/lr_finder.py).

* The learning rates are optax's ``exponential_decay`` to the float32 bit.
* The sweep itself: an image-only survival sweep of a TinyCNN at 12^3
  (dropout 0, augmentation patched off in both packages, the same weights
  in both) on the same cohort, cut to the default sweep's first 20 steps
  (``lr_end`` 1e-7 x 1e9^(20/100), ``num_iters`` 20: the same rates, 1e-7
  to 5e-6, before the sweep's rates make the loss chaotic and then inf;
  a JAX step of it takes ~0.3 s here). Its 20 smoothed losses are held in
  relative L2 against the JAX sweep's, within CONTROL_FACTOR x a
  JAX-vs-JAX control's distance (the JAX sweep on the images scaled by
  1 + 2^-22) or FLOOR, whichever is larger. A planted fault, the port's
  sweep with the smoothing 0.1 in place of 0.05, lies beyond that limit
  (checked in the test). Measured here: port 3.6e-7, control 4.0e-7, the
  fault 4.2e-2.
* ``python -m mmnn_sts_torch --classification --preop --lr_finder
  --device cpu`` writes lr_finder.png to the working directory, as the
  JAX CLI does (tests/test_end_to_end.py:345-359), and logs the min-loss
  rate.
"""

import functools
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

import mmnn_sts_tpu.pipeline as jpipe
import mmnn_sts_tpu.train.lr_finder as jax_lr_finder
import mmnn_sts_torch.pipeline as tpipe
import mmnn_sts_torch.train.lr_finder as port_lr_finder
from fixtures import make_full_cohort
from mmnn_sts_tpu.config import Config as JaxConfig
from mmnn_sts_torch.cli import main as port_main
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
from mmnn_sts_torch.models import build_model
from test_torch_convert import jax_variables, randomise

torch.set_num_threads(1)

N_COHORT, SIDE = 23, 12
CONTROL_FACTOR, FLOOR = 4.0, 1e-6
# the default sweep (1e-7 to 100 in 100 steps) cut to its first 20 steps
STEPS = 20
SWEEP = dict(lr_end=1e-7 * 1e9 ** (STEPS / 100), num_iters=STEPS)


@pytest.mark.parametrize("start,end,iters", [(1e-7, 100.0, 100),
                                             (1e-5, 1.0, 37)])
def test_schedule_is_optaxs_to_the_bit(start, end, iters):
    want = optax.exponential_decay(init_value=start, transition_steps=1,
                                   decay_rate=(end / start) ** (1.0 / iters))
    got = port_lr_finder.exponential_schedule(start, end, iters)
    for step in range(iters + 1):
        assert np.float32(got(step)) == np.float32(want(step)), step
    assert np.float32(got(0)) == np.float32(start)


def test_the_cut_sweep_takes_the_default_sweeps_rates():
    cut = port_lr_finder.exponential_schedule(1e-7, SWEEP["lr_end"], STEPS)
    full = port_lr_finder.exponential_schedule(1e-7, 100.0, 100)
    assert [np.float32(cut(i)) for i in range(STEPS)] == \
        [np.float32(full(i)) for i in range(STEPS)]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("lr_finder")
    paths, _ = make_full_cohort(str(root), n=N_COHORT)
    cfgs = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        cfg.data.data_loc = paths["clinical"]
        cfg.data.image_loc = paths["root"]
        cfg.data.key_loc = paths["key"]
        cfg.image_model.name = "tinycnn"
        cfg.image_model.spatial_size = [SIDE] * 3
        cfg.image_model.dropout_prob = 0.0
        cfg.hyperparameters.train_batch_size = 4
        cfg.hyperparameters.seed = 5
        cfgs.append(cfg)
    flags = dict(images=True, survival=True, lr_finder=True)
    torch.manual_seed(0)
    model = build_model(cfgs[0], True, False, False, False)
    flat = randomise(to_jax_flat(model.state_dict()), seed=2)
    return dict(root=root, paths=paths, cfgs=cfgs, flags=flags, flat=flat,
                tbundle=tpipe.load_cohort(cfgs[0], tpipe.TaskFlags(**flags)),
                jbundle=jpipe.load_cohort(cfgs[1], jpipe.TaskFlags(**flags)))


def _jax_sweep(c, scale=1.0):
    """The JAX package's find_lr on one device, from the cohort's weights,
    augmentation off, the images scaled by ``scale``."""
    create_state = jax_lr_finder.create_train_state

    def state_with_weights(*args, **kw):
        state = create_state(*args, **kw)
        v = jax_variables(c["flat"])
        return state.replace(params=v["params"],
                             batch_stats=v["batch_stats"])

    def scaled(*args, **kw):
        ds = jpipe.make_split_dataset(*args, **kw)
        ds.inputs["image"] = ds.inputs["image"] * np.float32(scale)
        return ds

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lr_finder, "create_train_state", state_with_weights)
        mp.setattr(jax_lr_finder, "make_split_dataset", scaled)
        mp.setattr(jax_lr_finder, "survival_train_superstep", functools.partial(
            jax_lr_finder.survival_train_superstep, augment=False))
        return jax_lr_finder.find_lr(
            c["cfgs"][1], jpipe.TaskFlags(**c["flags"]), c["jbundle"], mesh,
            output_dir=str(c["root"]), **SWEEP)


def _port_sweep(c, **kw):
    def model_with_weights(*args, **kwargs):
        return load_jax_npz(build_model(*args, **kwargs), c["flat"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_lr_finder, "build_model", model_with_weights)
        mp.setattr(port_lr_finder, "survival_train_superstep",
                   functools.partial(port_lr_finder.survival_train_superstep,
                                     augment=False))
        return port_lr_finder.find_lr(
            c["cfgs"][0], tpipe.TaskFlags(**c["flags"]), c["tbundle"], "cpu",
            output_dir=str(c["root"]), **SWEEP, **kw)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_sweep_matches_jax(cohort):
    jax_lrs, jax_losses = _jax_sweep(cohort)
    control = _rel(_jax_sweep(cohort, 1.0 + 2.0 ** -22)[1], jax_losses)
    lrs, losses = _port_sweep(cohort)
    assert len(lrs) == len(losses) == STEPS
    assert np.array_equal(np.float32(lrs), np.float32(jax_lrs))
    assert np.all(np.isfinite(losses))
    limit = max(CONTROL_FACTOR * control, FLOOR)
    got = _rel(losses, jax_losses)
    fault = _rel(_port_sweep(cohort, smoothing=0.1)[1], jax_losses)
    print(f"{STEPS} smoothed losses, relative L2 to JAX's: port "
          f"{got:.2e}, JAX control {control:.2e}, planted fault {fault:.2e} "
          f"(limit {limit:.1e})")
    assert got <= limit
    assert fault > limit
    best = lrs[int(np.nanargmin(losses))]
    assert np.isfinite(best) and np.float32(1e-7) <= best <= lrs[-1]


def test_cli_lr_finder_draws_lr_finder_png(cohort, tmp_path, capsys):
    """The port's CLI in the way the JAX package's end-to-end test runs it:
    a clinical-only classification sweep of the default 100 steps, the PNG
    in the working directory."""
    config = tmp_path / "config.json"
    config.write_text(json.dumps({
        "Data": {"data_loc": cohort["paths"]["clinical"],
                 "image_loc": cohort["paths"]["root"],
                 "key_loc": cohort["paths"]["key"]},
        "ImageModel": {"spatial_size": [SIDE] * 3},
        "Hyperparameters": {"train_batch_size": 4}}))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = port_main(["--classification", "--preop", "--lr_finder",
                        "--split", "--config", str(config),
                        "--output_path", str(tmp_path / "out"),
                        "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    assert (tmp_path / "lr_finder.png").stat().st_size > 0
    assert "lr_finder: min-loss lr = " in capsys.readouterr().out
    assert not (tmp_path / "out" / "metrics.jsonl").exists()
