"""The port's training augmentation (``mmnn_sts_torch/ops/augment.py``)
held against the JAX package's ``ops/augment.py``.

The deterministic transforms are compared given the same parameters, on
MRI-like volumes (squared normals x 500) of 16^3 x 2 channels after the
normalise + scale stage (values in [0, 1]):

* ``spatial_transform`` (JAX ``_spatial_transform_cf``) over theta across
  several quarter turns (negative ones, and residuals near +-pi/4), every
  flip axis 0-3 and zoom 0.9 / 1.0 / 1.1: atol 2e-5. The two packages'
  ``tan`` and ``sin`` may differ in the last bit, which moves a source
  coordinate by an ulp; linear interpolation is continuous, so the voxels
  move by as little;
* ``gaussian_blur`` over random sigma, ``adjust_contrast`` over gamma and
  ``histogram_shift`` given the same control points: atol 1e-5 (``exp``
  and ``pow`` differ in the last bit, sums run in another order);
* the whole pipeline: the test redraws ``train_augment``'s parameters from
  a JAX key with ``jax.random`` exactly as augment.py:353-407 does, feeds
  them to the port's ``apply_train_augment`` and holds the result against
  JAX's ``train_augment(vol, key)`` for 8 keys: atol 2e-5 plus 1e-6 x the
  sharpening's alpha (up to 30), which multiplies the difference of two
  blurs.

Measured on the CPU: 3.0e-6 at most for the spatial transform, 1.5e-6 for
the whole pipeline (a key with rotation, contrast, smoothing and
sharpening).

The port's own draws cannot match JAX's bits; they are held statistically:
each application rate within 5 binomial standard deviations over 2,000
draws, each range respected.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmnn_sts_tpu.ops import augment as jaug
from mmnn_sts_torch.ops import augment as taug

torch.set_num_threads(1)

SIDE, CH = 16, 2
SPATIAL_TOL = dict(rtol=0, atol=2e-5)
OP_TOL = dict(rtol=0, atol=1e-5)
PIPELINE_ATOL, SHARPEN_ATOL_PER_ALPHA = 2e-5, 1e-6
N_KEYS, N_DRAWS = 8, 2000
THETAS = [0.0, 0.3, -0.7, 0.78, -0.79, math.pi / 2 + 0.6, -2.0, 3.5, -14.2,
          14.9]


def _volumes(seed, n):
    """(n, D, H, W, C) MRI-like volumes."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, SIDE, SIDE, SIDE, CH)) ** 2
            * 500).astype(np.float32)


def _unit_cf(seed, n):
    """(n, C, D, H, W) volumes after the normalise + scale stage."""
    vols = torch.from_numpy(_volumes(seed, n)).permute(0, 4, 1, 2, 3)
    return taug.eval_transform_batch(vols).contiguous()


def test_spatial_transform_matches_jax():
    combos = [(t, f, z) for t in THETAS for f in range(4)
              for z in (0.9, 1.0, 1.1)]
    vols = _unit_cf(0, 1).expand(len(combos), -1, -1, -1, -1).contiguous()
    theta = torch.tensor([c[0] for c in combos], dtype=torch.float32)
    flip = torch.tensor([c[1] for c in combos])
    zoom = torch.tensor([c[2] for c in combos], dtype=torch.float32)
    got = taug.spatial_transform(vols, theta, flip, zoom).numpy()
    fn = jax.jit(jaug._spatial_transform_cf)
    vol = jnp.asarray(vols[0].numpy())
    for i, (t, f, z) in enumerate(combos):
        want = np.asarray(fn(vol, jnp.float32(t), jnp.int32(f),
                             jnp.float32(z)))
        np.testing.assert_allclose(got[i], want, **SPATIAL_TOL,
                                   err_msg=f"theta={t} flip={f} zoom={z}")


def test_quarter_turn_rounds_half_to_even_and_wraps_negative():
    """k = round(theta / (pi/2)) mod 4 with round half to even and a floor
    modulo: -pi/2 is three quarter turns, 5 pi/2 is one."""
    vols = _unit_cf(1, 1).expand(3, -1, -1, -1, -1).contiguous()
    theta = torch.tensor([-math.pi / 2, 5 * math.pi / 2, 3 * math.pi / 2])
    got = taug.spatial_transform(vols, theta, torch.full((3,), 3),
                                 torch.ones(3))
    fn = jax.jit(jaug._spatial_transform_cf)
    for i in range(3):
        want = np.asarray(fn(jnp.asarray(vols[i].numpy()),
                             jnp.float32(theta[i].item()), jnp.int32(3),
                             jnp.float32(1.0)))
        np.testing.assert_allclose(got[i].numpy(), want, **SPATIAL_TOL)


def test_gaussian_blur_matches_jax():
    rng = np.random.default_rng(2)
    sigmas = rng.uniform(0.25, 1.5, (6, 3)).astype(np.float32)
    vols = _unit_cf(2, 6)
    got = taug.gaussian_blur(vols, torch.from_numpy(sigmas)).numpy()
    fn = jax.jit(jaug._gaussian_blur_cf)
    for i in range(6):
        want = np.asarray(fn(jnp.asarray(vols[i].numpy()),
                             jnp.asarray(sigmas[i])))
        np.testing.assert_allclose(got[i], want, **OP_TOL)


def test_adjust_contrast_matches_jax():
    gammas = np.array([0.5, 0.9, 1.7, 3.3, 4.5], np.float32)
    vols = _unit_cf(3, len(gammas))
    got = taug.adjust_contrast(vols, torch.from_numpy(gammas)).numpy()
    for i, g in enumerate(gammas):
        want = np.asarray(jaug.adjust_contrast(jnp.asarray(vols[i].numpy()),
                                               jnp.float32(g)))
        np.testing.assert_allclose(got[i], want, **OP_TOL)


def test_histogram_shift_given_the_same_control_points_matches_jax():
    keys = jax.random.split(jax.random.key(4), 4)
    vols = _unit_cf(4, 4)
    u = np.stack([np.asarray(jax.random.uniform(k, (10,))) for k in keys])
    got = taug.histogram_shift(vols, taug.control_points(torch.from_numpy(u)))
    for i, k in enumerate(keys):
        want = np.asarray(jaug.histogram_shift(jnp.asarray(vols[i].numpy()),
                                               k))
        np.testing.assert_allclose(got[i].numpy(), want, **OP_TOL)


def _jax_draws(key, shape_cf):
    """``train_augment``'s parameters from ``key``, drawn as
    augment.py:353-407 draws them, in the port's parameter names."""
    keys = jax.random.split(key, 20)
    r = jax.random
    theta = jnp.where(r.bernoulli(keys[0], 0.5),
                      r.uniform(keys[1], (), minval=-15.0, maxval=15.0), 0.0)
    flip = jnp.where(r.bernoulli(keys[2], 0.5), r.randint(keys[3], (), 0, 3),
                     3)
    zoom = jnp.where(r.bernoulli(keys[4], 0.5),
                     r.uniform(keys[5], (), minval=0.9, maxval=1.1), 1.0)
    return {
        "theta": theta, "flip_axis": flip, "zoom": zoom,
        "apply_shift": r.bernoulli(keys[6], 0.3),
        "offset": r.uniform(keys[7], (), minval=-0.1, maxval=0.1),
        "apply_contrast": r.bernoulli(keys[8], 0.3),
        "gamma": r.uniform(keys[9], (), minval=0.5, maxval=4.5),
        "apply_smooth": r.bernoulli(keys[10], 0.2),
        "smooth_sigma": r.uniform(keys[11], (3,), minval=0.25, maxval=1.5),
        "apply_sharpen": r.bernoulli(keys[12], 0.2),
        "sharpen_sigma": r.uniform(keys[13], (3,), minval=0.5, maxval=1.0),
        "sharpen_alpha": r.uniform(keys[14], (), minval=10.0, maxval=30.0),
        "apply_histogram": r.bernoulli(keys[15], 0.3),
        "hist_u": r.uniform(keys[16], (10,)),
        "noise_std": r.uniform(keys[17], (), minval=0.0, maxval=0.05),
        "noise": r.normal(keys[18], shape_cf),
        "apply_noise": r.bernoulli(keys[19], 0.3),
    }


def test_train_augment_given_jax_draws_matches_jax():
    vols = _volumes(5, N_KEYS)
    keys = jax.random.split(jax.random.key(5), N_KEYS)
    draws = [_jax_draws(k, (CH, SIDE, SIDE, SIDE)) for k in keys]
    params = {name: torch.from_numpy(np.stack([np.asarray(d[name])
                                               for d in draws]))
              for name in draws[0]}
    params["flip_axis"] = params["flip_axis"].long()
    params["hist_points"] = taug.control_points(params.pop("hist_u"))
    got = taug.apply_train_augment(torch.from_numpy(vols), params).numpy()
    fn = jax.jit(jaug.train_augment)
    for i, k in enumerate(keys):
        want = np.asarray(fn(jnp.asarray(vols[i]), k))
        sharpened = bool(params["apply_sharpen"][i])
        atol = PIPELINE_ATOL + SHARPEN_ATOL_PER_ALPHA * float(
            params["sharpen_alpha"][i]) * sharpened
        np.testing.assert_allclose(got[i], want, rtol=0, atol=atol,
                                   err_msg=f"key {i}")
    # the keys exercise the stochastic ops, not only the identity
    for flag in ("apply_shift", "apply_contrast", "apply_histogram",
                 "apply_noise"):
        assert params[flag].any(), flag
    assert (params["theta"] != 0).any() and (params["flip_axis"] < 3).any()


def test_draw_augment_params_rates_and_ranges():
    gen = torch.Generator().manual_seed(0)
    p = taug.draw_augment_params(N_DRAWS, gen, "cpu", (4, 4, 4, 2))

    def within(rate, prob, what):
        sd = math.sqrt(prob * (1 - prob) / N_DRAWS)
        assert abs(rate - prob) <= 5 * sd, (what, rate, prob)

    within((p["theta"] != 0).float().mean().item(), 0.5, "rotate")
    within((p["flip_axis"] != 3).float().mean().item(), 0.5, "flip")
    within((p["zoom"] != 1).float().mean().item(), 0.5, "zoom")
    for name, prob in [("shift", 0.3), ("contrast", 0.3), ("smooth", 0.2),
                       ("sharpen", 0.2), ("histogram", 0.3), ("noise", 0.3)]:
        within(p[f"apply_{name}"].float().mean().item(), prob, name)
    assert p["theta"].abs().max() <= 15.0
    assert set(p["flip_axis"].unique().tolist()) == {0, 1, 2, 3}
    assert ((p["zoom"] >= 0.9) & (p["zoom"] <= 1.1)).all()
    for name, lo, hi in [("offset", -0.1, 0.1), ("gamma", 0.5, 4.5),
                         ("smooth_sigma", 0.25, 1.5),
                         ("sharpen_sigma", 0.5, 1.0),
                         ("sharpen_alpha", 10.0, 30.0),
                         ("noise_std", 0.0, 0.05)]:
        assert ((p[name] >= lo) & (p[name] <= hi)).all(), name
    pts = p["hist_points"]
    assert pts.shape == (N_DRAWS, 10) and (pts.diff(dim=1) >= 0).all()
    assert torch.allclose(pts[:, 0], torch.zeros(N_DRAWS))
    assert torch.allclose(pts[:, -1], torch.ones(N_DRAWS))
    assert p["noise"].shape == (N_DRAWS, 2, 4, 4, 4)
    assert abs(p["noise"].mean().item()) < 0.01
    assert abs(p["noise"].std().item() - 1.0) < 0.01


def test_train_augment_batch_is_reproducible_from_the_generator():
    vols = torch.from_numpy(_volumes(6, 3))
    a = taug.train_augment_batch(vols, torch.Generator().manual_seed(7))
    b = taug.train_augment_batch(vols, torch.Generator().manual_seed(7))
    assert a.shape == vols.shape and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_superstep_with_augmentation_is_finite():
    from mmnn_sts_torch.models.densenet import tiny_densenet
    from mmnn_sts_torch.models.multimodal import MultiModalModel
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    torch.manual_seed(0)
    encoder = tiny_densenet(growth_rate=8, init_features=16, bn_size=2,
                            feature_channels=4, in_channels=2,
                            out_channels=None)
    model = MultiModalModel(encoder, 11, num_classes=2, num_features=4,
                            blend=True)
    state = create_train_state(model, *make_optimizer(
        model.parameters(), 1e-2, 1, 4), seed=0)
    rng = np.random.default_rng(8)
    inputs = {"image": torch.from_numpy(_volumes(8, 8)).view(
                  2, 4, SIDE, SIDE, SIDE, CH),
              "clinical": torch.from_numpy(
                  rng.normal(size=(2, 4, 11)).astype(np.float32))}
    events = torch.from_numpy((rng.random((2, 4, 2)) < 0.7).astype(np.float32))
    durations = torch.from_numpy(rng.integers(1, 5, (2, 4, 2)).astype(
        np.float32))
    aux = survival_train_superstep(state, inputs, events, durations,
                                   blend=True, augment=True)
    assert state.step == 1 and torch.isfinite(aux["loss"])
    assert aux["preds"].shape == (2, 3, 4, 2)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
