"""The port's inference (``infer/run.py``), the batched weighted C-index
(``ops/metrics.concordance_index_resamples``) and the prediction CSVs
(``infer/artifacts.py``) held against the JAX package's.

* The C-index of R resamples given as count vectors against
  ``concordance_index_jax`` vmapped over the same counts: pairs tied in
  float32 but not in float64 (durations and predictions), and a degenerate
  resample (no admissible pair: NaN and weight 0 in both). Equal to 1e-6
  (the sums are of small integers, exact in float32).
* The resample stream, bitwise sklearn ``resample``'s.
* ``inference_survival`` (with ``bootstrap``, and without: C-indices and
  predictions) and ``inference_classification`` (with its Grad-CAM
  directories) in both packages on one synthetic split of 10 patients and
  one set of weights: a narrow TinyDenseNet blend model at 16^3 x 2ch
  with the 11-input clinical MLP, the JAX init redrawn by ``randomise`` and
  carried across by ``convert.py``. Resample C-indices, means and stds
  within 1e-6; predictions within 1e-5; the same directory names (no
  probability lies within 1e-3 of the threshold, checked).
* Both CSVs byte-equal to the JAX package's pandas files on the same
  arrays (float32 values, a NaN, a large uid).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmnn_sts_tpu.data.loader import build_device_dataset as jax_dataset
from mmnn_sts_tpu.infer import artifacts as jax_artifacts
from mmnn_sts_tpu.infer import run as jax_run
from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny_densenet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.ops.metrics import concordance_index_jax
from mmnn_sts_tpu.train.state import create_train_state as jax_create_state
from mmnn_sts_torch.convert import load_jax_npz
from mmnn_sts_torch.data.loader import build_device_dataset
from mmnn_sts_torch.infer import artifacts, run
from mmnn_sts_torch.models.densenet import tiny_densenet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.ops.augment import eval_transform_batch
from mmnn_sts_torch.ops.metrics import (
    concordance_index,
    concordance_index_resamples,
)
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from test_torch_convert import jax_flat, jax_variables, randomise

torch.set_num_threads(1)

N, SIDE, P, C = 10, 16, 11, 2
TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)
PRED_TOL = 1e-5


def _ties_case():
    """12 samples whose durations and predictions hold pairs tied in
    float32 only, and resample counts with a degenerate last row."""
    rng = np.random.default_rng(4)
    d = rng.integers(1, 6, 12).astype(np.float64)
    p = rng.normal(size=12)
    e = (rng.random(12) < 0.6).astype(np.float64)
    # two deaths tied in float32 only: admissible in float64 alone
    d[:2], e[:2] = (2.0, 2.0 + 1e-9), 1.0
    # an admissible pair whose predictions tie in float32 only
    d[2:4], e[2], p[2:4] = (1.0, 4.0), 1.0, (0.7 * (1 + 1e-12), 0.7)
    counts = run.bootstrap_counts(12, 7, seed=3)
    degenerate = np.zeros(12, np.float32)
    degenerate[np.flatnonzero(e == 0)[0]] = 12.0  # one censored sample
    return d, p, e, np.concatenate([counts, degenerate[None]])


def test_resample_cindices_match_jax():
    d, p, e, counts = _ties_case()
    c, adm = concordance_index_resamples(*(torch.from_numpy(a) for a in
                                           (d, p, e, counts)))
    want_c, want_adm = jax.vmap(lambda w: concordance_index_jax(
        jnp.asarray(d), jnp.asarray(p), jnp.asarray(e), w))(
            jnp.asarray(counts))
    np.testing.assert_allclose(adm.numpy(), np.asarray(want_adm), rtol=0,
                               atol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-6, equal_nan=True)
    assert c.dtype == torch.float32 and c.shape == (counts.shape[0],)
    assert np.isnan(c[-1].item()) and adm[-1].item() == 0.0
    assert np.isfinite(c[:-1].numpy()).all()
    # all ones: the host C-index on the float32 values (float32 ties)
    ones = torch.ones(1, 12)
    c1, _ = concordance_index_resamples(*(torch.from_numpy(a) for a in
                                          (d, p, e)), ones)
    want = concordance_index(d.astype(np.float32), p.astype(np.float32), e)
    assert c1.item() == pytest.approx(want, abs=1e-6)
    assert want != concordance_index(d, p, e)  # the float32 ties matter


def test_bootstrap_counts_match_sklearn_resample():
    sk = pytest.importorskip("sklearn.utils")
    n, seed, iters = 23, 42, 10
    uids = np.arange(100, 100 + n)
    np.random.seed(seed)
    want = np.zeros((iters, n), np.float32)
    for r in range(iters):
        for u in sk.resample(uids):
            want[r, u - 100] += 1
    np.testing.assert_array_equal(run.bootstrap_counts(n, iters, seed), want)


def _split(seed=0):
    rng = np.random.default_rng(seed)
    image = (rng.normal(size=(N,) + (SIDE,) * 3 + (2,)) ** 2 * 500
             ).astype(np.float32)
    clinical = rng.normal(size=(N, P)).astype(np.float32)
    labels = np.zeros((N, C), np.float32)
    labels[rng.permutation(N)[:4], 0] = 1.0
    labels[rng.permutation(N)[:5], 1] = 1.0
    events = (rng.random((N, C)) < 0.6).astype(np.float32)
    events[:2] = 1.0
    durations = rng.integers(1, 6, (N, C)).astype(np.float32)  # ties
    return dict(uids=1000 + np.arange(N), image_volumes=image,
                clinical=clinical, labels=labels, events=events,
                durations=durations)


@pytest.fixture(scope="module")
def setup():
    """Both packages' states on the same weights, and one split each."""
    jmodel = JaxMultiModal(
        image_model=jax_tiny_densenet(**TINY, out_channels=C,
                                      dropout_prob=0.0),
        num_clinical_inputs=P, num_classes=C, num_features=4, blend=True,
        clinical_dropout_prob=0.0)
    sample = {"image": jnp.zeros((1,) + (SIDE,) * 3 + (2,)),
              "clinical": jnp.zeros((1, P))}
    jstate = jax_create_state(jmodel, optax.sgd(1e-2), sample, seed=0)
    flat = randomise(jax_flat({"params": jstate.params,
                               "batch_stats": jstate.batch_stats}), seed=9)
    variables = jax_variables(flat)
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    model = MultiModalModel(
        tiny_densenet(**TINY, out_channels=None, dropout_prob=0.0), P,
        num_classes=C, num_features=4, blend=True, clinical_dropout_prob=0.0)
    load_jax_npz(model, flat)
    state = create_train_state(model, *make_optimizer(model.parameters(),
                                                      1e-2, 1, 1), seed=0)
    arrays = _split()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return dict(jstate=jstate, state=state, arrays=arrays,
                jds=jax_dataset(arrays["uids"], mesh, **{
                    k: v for k, v in arrays.items() if k != "uids"}),
                ds=build_device_dataset(arrays["uids"], "cpu", **{
                    k: v for k, v in arrays.items() if k != "uids"}))


def _cfgs(out, **kw):
    return (jax_run.InferenceConfig(blend=True, output_dir=str(out), seed=7,
                                    **kw),
            run.InferenceConfig(blend=True, output_dir=str(out), seed=7,
                                **kw))


def test_bootstrap_inference_matches_jax(setup, tmp_path):
    jcfg, cfg = _cfgs(tmp_path, bootstrap=True, gradcam=False)
    want = jax_run.inference_survival(setup["jstate"], setup["jds"], jcfg)
    got = run.inference_survival(setup["state"], setup["ds"], cfg)
    assert got["resample_c"].shape == want["resample_c"].shape
    assert 40 <= got["resample_c"].shape[0] <= 50  # degenerate ones dropped
    for key in ("resample_c", "mean_c", "std_c"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    # the population standard deviation (ddof 0)
    np.testing.assert_allclose(got["std_c"], got["resample_c"].std(0),
                               rtol=1e-6)


def test_survival_inference_matches_jax(setup, tmp_path):
    jcfg, cfg = _cfgs(tmp_path, gradcam=False)
    want = jax_run.inference_survival(setup["jstate"], setup["jds"], jcfg)
    got = run.inference_survival(setup["state"], setup["ds"], cfg)
    np.testing.assert_allclose(got["preds"], want["preds"], rtol=PRED_TOL,
                               atol=PRED_TOL)
    np.testing.assert_allclose(got["c_indices"], want["c_indices"], rtol=0,
                               atol=1e-12)
    text = (tmp_path / "survival_model_predictions.csv").read_text()
    assert text.splitlines()[0] == ("MRN,VS_pred,DM_pred,VS_event,DM_event,"
                                    "VS_duration,DM_duration")
    assert len(text.splitlines()) == N + 1


def test_classification_inference_matches_jax(setup, tmp_path):
    jcfg, cfg = _cfgs(tmp_path / "jax")
    want = jax_run.inference_classification(setup["jstate"], setup["jds"],
                                            jcfg)
    pcfg = run.InferenceConfig(blend=True, output_dir=str(tmp_path / "port"))
    got = run.inference_classification(setup["state"], setup["ds"], pcfg)
    assert np.abs(want["probs"] - 0.5).min() > 1e-3  # no label on the edge
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                               atol=PRED_TOL)
    np.testing.assert_array_equal(got["f1s"], want["f1s"])
    dirs = sorted(os.listdir(tmp_path / "port" / "attention_maps"))
    assert dirs == sorted(os.listdir(tmp_path / "jax" / "attention_maps"))
    assert len(dirs) == N and len({d.split("_")[1] for d in dirs}) > 1
    for d in dirs:
        assert sorted(os.listdir(tmp_path / "port" / "attention_maps" / d)) \
            == ["att_map.nii.gz", "att_map_cls1.nii.gz", "probabilities.txt",
                "t1image.nii.gz", "t2image.nii.gz"]
    rows = (tmp_path / "port" / "model_probabilities.csv").read_text()
    assert rows.splitlines()[0] == "0,1,2,3,4"
    assert rows.splitlines()[1].startswith("1000.0,")


def test_survival_attention_export_matches_jax(setup, tmp_path):
    """The survival directories (``_patient_{uid}``) and each patient's own
    forward in preds.txt (its values parsed back by length: JAX writes
    them with no separator)."""
    jcfg, cfg = _cfgs(tmp_path / "jax")
    jax_run.export_attention_maps(setup["jstate"], setup["jds"], jcfg,
                                  survival=True)
    pcfg = run.InferenceConfig(blend=True, output_dir=str(tmp_path / "port"))
    run.export_attention_maps(setup["state"], setup["ds"], pcfg,
                              survival=True)
    dirs = sorted(os.listdir(tmp_path / "port" / "attention_maps"))
    assert dirs == sorted(os.listdir(tmp_path / "jax" / "attention_maps")) \
        == sorted(f"_patient_{u}" for u in setup["arrays"]["uids"])
    inputs = {**setup["ds"].inputs,
              "image": eval_transform_batch(setup["ds"].inputs["image"])}
    with torch.no_grad():
        head0 = setup["state"].model.eval()(inputs)[0].numpy()
    for i, uid in enumerate(setup["arrays"]["uids"]):
        got, want = (_parse_two((tmp_path / side / "attention_maps"
                                 / f"_patient_{uid}" / "preds.txt"
                                 ).read_text()) for side in ("port", "jax"))
        np.testing.assert_allclose(got, head0[i], rtol=0, atol=PRED_TOL)
        np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL)


def _parse_two(text):
    """Two floats written back to back (``str(float)`` of each)."""
    for cut in range(1, len(text)):
        try:
            a, b = float(text[:cut]), float(text[cut:])
        except ValueError:
            continue
        if str(a) == text[:cut] and str(b) == text[cut:]:
            return np.array([a, b])
    raise ValueError(text)


def test_csvs_are_byte_equal_to_pandas(tmp_path):
    rng = np.random.default_rng(2)
    uids = np.array([7, 12, 123456789, 1003])
    preds = rng.normal(size=(4, 2)).astype(np.float32)
    preds[1, 0] = np.nan
    events = (rng.random((4, 2)) < 0.5).astype(np.float32)
    durations = rng.integers(1, 3000, (4, 2)).astype(np.float32)
    probs = (1.0 / (1.0 + np.exp(-preds))).astype(np.float32)
    for name, args in (
            ("save_survival_predictions_csv",
             (uids, preds, events, durations)),
            ("save_probabilities_csv", (uids, probs, events))):
        getattr(jax_artifacts, name)(str(tmp_path / "jax.csv"), *args)
        getattr(artifacts, name)(str(tmp_path / "port.csv"), *args)
        assert (tmp_path / "port.csv").read_bytes() == \
            (tmp_path / "jax.csv").read_bytes(), name
