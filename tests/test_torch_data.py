"""The port's cohort build and loader (``mmnn_sts_torch/data``,
``pipeline.py``, ``utils/store.py``) held against the JAX package's.

* NIfTI files written by either package read back bit-identically in the
  other.
* ``ClinicalArrays`` (pandas in the JAX package, the ``csv`` module here)
  are identical, NaN in the same places, on the fixture CSV and on an
  edge-case CSV (missing dates, empty categorical cells, ``%`` necrosis,
  missing events and times); a time that ``FUtime`` cannot fill raises in
  both.
* ``stratified_split`` gives identical UID lists at three seeds.
* The image cohort's plain path (``build_image_cohort(...,
  use_native=False)``) equals the JAX package's numpy path
  (``load_patient_volume(use_native=False)``) exactly, and its default path
  (the C++ pool) lies within rtol/atol 1e-5 of it, the tolerance
  tests/test_native.py holds the pool to. Every comparison names the JAX
  package's numpy path: whether its default path takes its own C++ pool
  depends on whether that library was built in the test process.
* ``EpochBatcher``'s indices and masks are identical over a grid of N,
  microbatch and accumulation; ``gather_superbatch`` and
  ``standardize_bundle`` agree exactly; ``make_split_dataset`` makes the
  same splits, device-resident and host-resident.
* A subprocess with pandas, matplotlib, yaml, jax, flax, optax and the JAX
  package blocked builds the cohort from a JSON config, resident and on
  the host, and imports the training loop and its CUDA-graph module.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fixtures import make_clinical_csv, make_full_cohort
from mmnn_sts_torch import pipeline as tpipe
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.data import images as timages
from mmnn_sts_torch.data import loader as tloader
from mmnn_sts_torch.data import nifti as tnifti
from mmnn_sts_torch.data import split as tsplit
from mmnn_sts_torch.data import tabular as ttab
from mmnn_sts_tpu import pipeline as jpipe
from mmnn_sts_tpu.config import Config as JaxConfig
from mmnn_sts_tpu.data import images as jimages
from mmnn_sts_tpu.data import loader as jloader
from mmnn_sts_tpu.data import nifti as jnifti
from mmnn_sts_tpu.data import split as jsplit
from mmnn_sts_tpu.data import tabular as jtab

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COHORT, SIDE = 24, 8
COHORT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    paths, uids = make_full_cohort(root, n=N_COHORT)
    return paths, uids


def _configs(paths):
    """The same settings in both packages' Config: the cohort's paths and
    an 8^3 grid."""
    out = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        cfg.data.data_loc = paths["clinical"]
        cfg.data.image_loc = paths["root"]
        cfg.data.key_loc = paths["key"]
        cfg.image_model.spatial_size = [SIDE] * 3
        out.append(cfg)
    return out


@pytest.mark.parametrize("name", ["v.nii", "v.nii.gz"])
def test_nifti_round_trips_across_packages(tmp_path, name):
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(5, 6, 7)).astype(np.float32)
    a, b = str(tmp_path / f"a_{name}"), str(tmp_path / f"b_{name}")
    tnifti.save_nifti(a, vol)
    jnifti.save_nifti(b, vol)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if name.endswith(".nii"):
            assert fa.read() == fb.read()
    for reader in (jnifti.load_nifti, tnifti.load_nifti):
        for path in (a, b):
            got = reader(path, dtype=np.float32)
            assert got.shape == vol.shape and np.array_equal(got, vol)


EDGE_CSV = """MRN,Sex,Age,Location3,Diagnosis,Chemo (Neoadjuvant),TumorSize,\
TumorVolume (cm^3),"TumorDepth (1 = deep to fascia, 0 = superficial) ",\
TumorGrade,Metsatpresentation,"RT Type (0 = preop, 1 = postop",\
"Margin (negative==0, microscopically positive==1, grossly positive==2)",\
Necrosis % (information not known prior to operation),LengthOR,\
VitalStatus,Distant metastasis,FUtime,Date of Distant Mets,Surgery_Date,Extra
7,M,50,Thigh,MFH,Yes,3.5,100.0,1,2,0,1,0,12%,100,1,1,900,2016-03-01,2015-01-01,x
3,,61,,Synovial,No,,2000.0,0,3,1,0,1,,150,,0,1200,,2015-02-03,y
9,F,,Arm,,Yes,7.25,600.5,,1,0,1,2,-1%,,0,,40,2015-12-31,2015-01-01,z
5,M,44,Thigh,MFH,,1.0,,1,,0,0,0,5%,90,1,1,365,,,w
11,F,38,Pelvis,Liposarcoma,No,2.0,1500.0,0,2,1,1,1,100%,200,0,0,2400,2014-06-01,2015-01-01,v
"""


def _clinical_pair(path, **kw):
    return (ttab.load_clinical_arrays(path, **kw),
            jtab.load_clinical_arrays(path, **kw))


def _assert_same_clinical(got, want):
    for name in ("uids", "predictors", "binary_targets", "events",
                 "durations"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.predictor_names == want.predictor_names
    assert list(got.raw) == list(want.raw.columns)
    for col in got.raw:
        np.testing.assert_array_equal(got.raw[col],
                                      want.raw[col].to_numpy(dtype=float),
                                      err_msg=col)


@pytest.mark.parametrize("signal", [False, True])
def test_clinical_arrays_match_jax_on_the_fixture_csv(tmp_path, signal):
    path = str(tmp_path / "clinical.csv")
    make_clinical_csv(path, n=40, seed=3, signal=signal)
    for preop, postop in ((True, False), (False, True), (True, True)):
        _assert_same_clinical(*_clinical_pair(path, preop=preop,
                                              postop=postop))


def test_clinical_arrays_match_jax_on_edge_cases(tmp_path):
    """Missing dates (Time_MET NaN, then filled from FUtime), empty
    categorical cells (a code of their own), '%' and '-1%' necrosis, a
    missing event (NaN is an event) and missing predictors."""
    path = str(tmp_path / "edge.csv")
    with open(path, "w") as f:
        f.write(EDGE_CSV)
    got, want = _clinical_pair(path, preop=True, postop=True)
    _assert_same_clinical(got, want)
    assert np.isnan(got.raw["Time_MET"]).sum() == 2
    assert np.isnan(got.predictors).any()


def test_unfillable_time_raises_in_both(tmp_path):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write(EDGE_CSV.replace(",0,1200,,2015-02-03,", ",0,,,2015-02-03,"))
    with pytest.raises(ValueError):
        jtab.load_clinical_arrays(path)
    with pytest.raises(ValueError):
        ttab.load_clinical_arrays(path)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_stratified_split_matches_jax(tmp_path, seed):
    path = str(tmp_path / "clinical.csv")
    uids = make_clinical_csv(path, n=60, seed=seed, signal=True)
    got_arrays, want_arrays = _clinical_pair(path)
    keep = uids[::2] + uids[1::4]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = tsplit.stratified_split(got_arrays.raw, keep, seed=seed,
                                  output_dir=str(tmp_path / "t"))
    want = jsplit.stratified_split(want_arrays.raw, keep, seed=seed,
                                   output_dir=str(tmp_path / "j"))
    assert got == tuple(want)
    for name in ("train_uids.txt", "val_uids.txt", "test_uids.txt"):
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package's cohort build on its numpy path: its C++ library
    reads as not built, whether or not a test built it in this process."""
    from mmnn_sts_tpu.data import native as jnative

    monkeypatch.setattr(jnative, "_load", lambda: None)


def test_image_cohort_matches_jax(cohort):
    paths, _ = cohort
    dirs = (paths["t1"], paths["t2"])
    got = timages.build_image_cohort(dirs, paths["key"], (SIDE,) * 3, "fill")
    plain = timages.build_image_cohort(dirs, paths["key"], (SIDE,) * 3,
                                       "fill", use_native=False)
    records = [{r.anon_id: r for r in jimages.build_manifest(d, paths["key"])}
               for d in dirs]
    anon_ids = sorted(records[0])
    np.testing.assert_array_equal(
        got.uids, [records[0][a].uid for a in anon_ids])
    np.testing.assert_array_equal(plain.uids, got.uids)
    assert got.volumes.shape == (N_COHORT, SIDE, SIDE, SIDE, 2)
    for i, anon in enumerate(anon_ids):
        for c in range(2):
            numpy_path = jimages.load_patient_volume(
                records[c][anon], (SIDE,) * 3, "fill", use_native=False)
            np.testing.assert_array_equal(plain.volumes[i, ..., c],
                                          numpy_path)
            np.testing.assert_allclose(got.volumes[i, ..., c], numpy_path,
                                       **COHORT_TOL)
    for zero_slices in ("crop", "none"):
        rec = records[0][sorted(records[0])[0]]
        image = tnifti.load_nifti(rec.image_path, np.float32)
        mask = tnifti.load_nifti(rec.mask_path, np.float32)
        np.testing.assert_array_equal(
            timages.apply_mask(image, mask, zero_slices),
            jimages.apply_mask(image, mask, zero_slices))


def test_radiomics_matches_jax(tmp_path):
    """A PyRadiomics-style CSV: UID, labels and diagnostic columns (one of
    them text) dropped, int and float features kept in the file's order."""
    from mmnn_sts_torch.data.radiomics import load_radiomics
    from mmnn_sts_tpu.data.radiomics import load_radiomics as jax_load

    rng = np.random.default_rng(4)
    path = tmp_path / "radiomics.csv"
    rows = ["MRN,diagnostics_Versions_PyRadiomics,original_f0,VitalStatus,"
            "original_f1,original_n"]
    for u in range(6):
        rows.append(f"{100 + u},v3.0,{rng.normal():.6f},{u % 2},"
                    f"{rng.normal() * 1e3:.3f},{int(rng.integers(0, 9))}")
    path.write_text("\n".join(rows) + "\n")
    got, want = load_radiomics(str(path)), jax_load(str(path))
    np.testing.assert_array_equal(got.uids, want.uids)
    np.testing.assert_array_equal(got.features, want.features)
    assert got.features.dtype == want.features.dtype == np.float32
    assert got.feature_names == want.feature_names


@pytest.mark.parametrize("n,micro,accum,two_level", [
    (n, micro, accum, two_level)
    for n in (1, 5, 17, 24, 67)
    for micro, accum, two_level in ((4, 2, True), (8, 8, True), (3, 1, True),
                                    (4, 1, False))
])
def test_epoch_batcher_matches_jax(n, micro, accum, two_level):
    kw = dict(num_samples=n, micro_batch=micro, accum_steps=accum, seed=11,
              two_level=two_level)
    got, want = tloader.EpochBatcher(**kw), jloader.EpochBatcher(**kw)
    assert got.steps_per_epoch() == want.steps_per_epoch()
    assert got.ragged == want.ragged
    np.testing.assert_array_equal(got.pad_mask(), want.pad_mask())
    for epoch in range(3):
        g, w = got.epoch_indices(epoch), want.epoch_indices(epoch)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_gather_superbatch_matches_jax():
    rng = np.random.default_rng(1)
    n = 13
    arrays = dict(image_volumes=rng.normal(size=(n, 4, 4, 4, 2)),
                  clinical=rng.normal(size=(n, 11)),
                  events=(rng.random((n, 2)) < 0.5).astype(np.float32),
                  durations=rng.integers(1, 9, (n, 2)))
    uids = np.arange(100, 100 + n)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    got_ds = tloader.build_device_dataset(uids, "cpu", **arrays)
    want_ds = jloader.build_device_dataset(uids, mesh, **arrays)
    idx = tloader.EpochBatcher(n, 4, 2, seed=3, two_level=True
                               ).epoch_indices(1)[-1]
    got = tloader.gather_superbatch(got_ds, idx)
    want = jloader.gather_superbatch(want_ds, idx, mesh)
    for k in ("image", "clinical"):
        np.testing.assert_array_equal(got["inputs"][k].numpy(),
                                      np.asarray(want["inputs"][k]))
    for k in ("events", "durations"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert "labels" not in got and "labels" not in want


def test_standardize_bundle_matches_jax(cohort):
    paths, _ = cohort
    tcfg, jcfg = _configs(paths)
    flags = dict(preop=True, survival=True)
    got = tpipe.load_cohort(tcfg, tpipe.TaskFlags(**flags))
    want = jpipe.load_cohort(jcfg, jpipe.TaskFlags(**flags))
    np.testing.assert_array_equal(got.uids, want.uids)
    train = [int(u) for u in got.uids[::3]]
    tpipe.standardize_bundle(got, train)
    jpipe.standardize_bundle(want, train)
    np.testing.assert_array_equal(got.clinical.predictors,
                                  want.clinical.predictors)


def test_make_split_dataset_matches_jax_and_needs_a_device(cohort,
                                                          jax_numpy_path):
    """Device-resident and (``TPU.device_resident_dataset: false``)
    host-resident, each against the JAX package's."""
    from mmnn_sts_torch.data.streaming import HostDataset

    paths, _ = cohort
    tcfg, jcfg = _configs(paths)
    flags = dict(images=True, preop=True, survival=True)
    got_b = tpipe.load_cohort(tcfg, tpipe.TaskFlags(**flags))
    want_b = jpipe.load_cohort(jcfg, jpipe.TaskFlags(**flags))
    uids = [int(u) for u in got_b.uids[1::2]] + [999999]  # not in the cohort
    got = tpipe.make_split_dataset(tcfg, tpipe.TaskFlags(**flags), got_b,
                                   uids, "cpu")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    want = jpipe.make_split_dataset(jcfg, jpipe.TaskFlags(**flags), want_b,
                                    uids, mesh)
    np.testing.assert_array_equal(got.uids, want.uids)
    for k in ("image", "clinical"):
        np.testing.assert_allclose(got.inputs[k].numpy(),
                                   np.asarray(want.inputs[k]), **COHORT_TOL)
    np.testing.assert_array_equal(got.events.numpy(), np.asarray(want.events))
    np.testing.assert_array_equal(got.durations.numpy(),
                                  np.asarray(want.durations))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpipe.make_split_dataset(tcfg, tpipe.TaskFlags(**flags), got_b,
                                     uids)
    # TPU.device_resident_dataset: false keeps the split on the host
    tcfg.tpu.device_resident_dataset = False
    host = tpipe.make_split_dataset(tcfg, tpipe.TaskFlags(**flags), got_b,
                                    uids, "cpu")
    want = jpipe.make_split_dataset(jcfg, jpipe.TaskFlags(**flags), want_b,
                                    uids, mesh, device_resident=False)
    assert isinstance(host, HostDataset) and host.device.type == "cpu"
    np.testing.assert_array_equal(host.uids, want.uids)
    for k in ("image", "clinical"):
        assert host.inputs[k].device.type == "cpu"
        np.testing.assert_allclose(host.inputs[k].numpy(),
                                   np.asarray(want.inputs[k]), **COHORT_TOL)
    np.testing.assert_array_equal(host.events.numpy(), want.events)
    np.testing.assert_array_equal(host.durations.numpy(), want.durations)


BLOCKED = ("pandas", "matplotlib", "yaml", "jax", "jaxlib", "flax", "optax",
           "mmnn_sts_tpu")
# run before anything else in a subprocess: every blocked package (and its
# submodules) fails to import
BLOCK_PRELUDE = (
    "import sys\n"
    f"for name in {BLOCKED!r}:\n"
    "    sys.modules[name] = None\n"
)


def run_blocked(script: str, cwd: str) -> subprocess.CompletedProcess:
    """``script`` in a fresh interpreter with ``BLOCKED`` unimportable;
    it must end by printing ok."""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", BLOCK_PRELUDE + script],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), (
        res.stdout[-2000:], res.stderr[-4000:])
    return res


def test_cohort_builds_without_pandas_yaml_or_jax(cohort, tmp_path):
    paths, _ = cohort
    cfg = {"Data": {"data_loc": paths["clinical"], "image_loc": paths["root"],
                    "key_loc": paths["key"]},
           "ImageModel": {"name": "tinydensenet",
                          "spatial_size": [SIDE] * 3}}
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    run_blocked(
        "from mmnn_sts_torch.config import parse_config\n"
        "from mmnn_sts_torch.pipeline import (TaskFlags, load_cohort,\n"
        "    make_split_dataset, resolve_splits)\n"
        f"cfg = parse_config({str(cfg_path)!r})\n"
        "flags = TaskFlags(images=True, preop=True, survival=True,\n"
        "                  blend=True, split=True)\n"
        "bundle = load_cohort(cfg, flags)\n"
        "train, val, test = resolve_splits(cfg, flags, bundle, 42)\n"
        "ds = make_split_dataset(cfg, flags, bundle, train, device='cpu')\n"
        f"assert ds.inputs['image'].shape[1:] == ({SIDE},) * 3 + (2,)\n"
        "import mmnn_sts_torch.train.graphs, mmnn_sts_torch.train.loop\n"
        "from mmnn_sts_torch.data.streaming import HostDataset\n"
        "cfg.tpu.device_resident_dataset = False\n"
        "host = make_split_dataset(cfg, flags, bundle, train, device='cpu')\n"
        "assert isinstance(host, HostDataset)\n"
        f"assert len(train) + len(val) + len(test) == {N_COHORT}\n"
        "print('ok')\n",
        str(tmp_path))
