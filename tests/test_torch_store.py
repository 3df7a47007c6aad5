"""The port's object-store layer (``utils/store.py``) and its ``s3://`` cohort
paths held against the JAX package's, with boto3 replaced by a stub backed
by a local directory (boto3 is not installed here), as tests/test_store.py
stubs it.

* Remote CSVs read into the same column tables as local ones (and as the
  JAX package's pandas frames); remote uid lists read as the JAX package
  reads them; ``resolve_splits`` takes ``s3://`` uid lists.
* ``build_manifest_s3`` and ``build_manifest_dicom_s3`` give the JAX
  package's records (uids, anon ids, and the fetched files' bytes), the
  volumes built from them equal the local cohort's, and an unparseable key
  raises in both. Every fetched object lies in the run's one temporary
  directory, and none is left once it is removed.
* Upload keys: the training artifacts land under ``dest_prefix`` with the
  JAX package's names (``train_artifact_names``), and
  ``inference_survival`` with a bucket uploads its prediction CSV; a CLI
  run whose every path is ``s3://`` trains and uploads.
* Without boto3, a remote path raises as in the JAX package, and
  ``upload_artifacts`` logs and returns False.
"""

import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from fixtures import make_dicom_cohort, make_full_cohort
from mmnn_sts_torch.data import images as timages
from mmnn_sts_torch.utils import store as tstore
from mmnn_sts_tpu.data import images as jimages
from mmnn_sts_tpu.utils import store as jstore

torch.set_num_threads(1)

SIDE = 8


class _Object:
    def __init__(self, path: Path, key: str):
        self.path, self.key = path, key

    def download_fileobj(self, f):
        f.write(self.path.read_bytes())


class _Objects:
    def __init__(self, root: Path):
        self.root = root

    def filter(self, Prefix=""):  # noqa: N803 (boto3's name)
        keys = sorted(p.relative_to(self.root).as_posix()
                      for p in self.root.rglob("*") if p.is_file())
        return [_Object(self.root / k, k) for k in keys
                if k.startswith(Prefix)]


class _Bucket:
    def __init__(self, root: Path, log: list):
        self.root, self.log = root, log
        self.objects = _Objects(root)

    def Object(self, key):  # noqa: N802
        return _Object(self.root / key, key)

    def download_file(self, key, path):
        shutil.copyfile(self.root / key, path)

    def upload_file(self, local, key):
        dest = self.root / key
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(local, dest)
        self.log.append((self.root.name, key))


class FakeBoto3:
    """``boto3.resource("s3")`` over ``root``: bucket b is ``root/b``."""

    def __init__(self, root: Path):
        self.root, self.uploads = Path(root), []

    def resource(self, kind):
        assert kind == "s3"
        return self

    def Bucket(self, name):  # noqa: N802
        return _Bucket(self.root / name, self.uploads)


@pytest.fixture
def s3(tmp_path, monkeypatch):
    fake = FakeBoto3(tmp_path / "s3")
    for mod in (tstore, jstore):
        monkeypatch.setattr(mod, "boto3", fake)
        monkeypatch.setattr(mod, "HAVE_BOTO3", True)
    return fake


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    nifti, _ = make_full_cohort(str(root / "nifti"), n=6)
    dicom, _ = make_dicom_cohort(str(root / "dicom"), n=4)
    return nifti, dicom


def _upload(tree, bucket_root: Path, prefix: str):
    """Copy a local tree under s3://<bucket>/<prefix>/."""
    shutil.copytree(tree, bucket_root / prefix, dirs_exist_ok=True)


def test_remote_csv_and_uids_read_as_local(s3, cohorts):
    nifti, _ = cohorts
    bucket = s3.root / "bkt"
    _upload(nifti["root"], bucket, "c")
    remote = tstore.read_csv("s3://bkt/c/clinical.csv")
    local = tstore.read_csv(nifti["clinical"])
    frame = jstore.read_csv_any("s3://bkt/c/clinical.csv")
    assert list(remote) == list(local) == list(frame.columns)
    for col in remote:
        assert remote[col].dtype == local[col].dtype
        if remote[col].dtype == object:  # str cells, NaN where missing
            assert list(map(repr, remote[col])) == list(map(repr, local[col]))
        else:
            np.testing.assert_array_equal(remote[col], local[col])
            np.testing.assert_array_equal(remote[col], frame[col].to_numpy())
    (bucket / "uids.txt").write_text("101\n102\n\n103\n")
    assert tstore.load_uids_any("s3://bkt/uids.txt") \
        == jstore.load_uids_any("s3://bkt/uids.txt") == [101, 102, 103]


def test_resolve_splits_reads_remote_uid_lists(s3):
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.pipeline import TaskFlags, resolve_splits

    bucket = s3.root / "bkt" / "splits"
    bucket.mkdir(parents=True)
    cfg = Config()
    for name, uids in (("train", "1\n2\n"), ("val", "3\n"), ("test", "4\n")):
        (bucket / f"{name}.txt").write_text(uids)
        setattr(cfg.preprocessing, f"{name}_uid_location",
                f"s3://bkt/splits/{name}.txt")
    assert resolve_splits(cfg, TaskFlags(survival=True), None, 0) \
        == ([1, 2], [3], [4])


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.anon_id, g.uid, g.format) == (w.anon_id, w.uid, w.format)
        for part in ("image_path", "mask_path"):
            a, b = Path(getattr(g, part)), Path(getattr(w, part))
            if a.is_dir():
                assert sorted(os.listdir(a)) == sorted(os.listdir(b))
                assert all((a / f).read_bytes() == (b / f).read_bytes()
                           for f in os.listdir(a))
            else:
                assert a.read_bytes() == b.read_bytes()


def test_s3_manifests_match_jax(s3, cohorts, tmp_path, monkeypatch):
    nifti, dicom = cohorts
    # the JAX package leaves its NIfTI fetches in the temporary directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bucket = s3.root / "bkt"
    # the NIfTI prefix holds the files flat, as an object listing does
    for pdir in sorted(Path(nifti["t1"]).iterdir()):
        for f in pdir.iterdir():
            (bucket / "nifti" / "t1").mkdir(parents=True, exist_ok=True)
            shutil.copyfile(f, bucket / "nifti" / "t1" / f.name)
    _upload(dicom["t1"], bucket, "dicom/t1")
    _same_records(timages.build_manifest_s3("s3://bkt/nifti/t1",
                                            nifti["key"]),
                  jimages.build_manifest_s3("s3://bkt/nifti/t1",
                                            nifti["key"]))
    got = timages.build_manifest_dicom_s3("s3://bkt/dicom/t1/",
                                          dicom["key"])
    _same_records(got, jimages.build_manifest_dicom_s3("s3://bkt/dicom/t1/",
                                                       dicom["key"]))
    local = timages.build_manifest_dicom(dicom["t1"], dicom["key"])
    assert [(r.anon_id, r.uid) for r in got] \
        == [(r.anon_id, r.uid) for r in local]
    for image_format, remote, here, key in (
            ("nifti", "s3://bkt/nifti/t1", nifti["t1"], nifti["key"]),
            ("dicom", "s3://bkt/dicom/t1/", dicom["t1"], dicom["key"])):
        a = timages.build_image_cohort(remote, key, (SIDE,) * 3,
                                       image_format=image_format)
        b = timages.build_image_cohort(here, key, (SIDE,) * 3,
                                       image_format=image_format)
        np.testing.assert_array_equal(a.uids, b.uids)
        np.testing.assert_array_equal(a.volumes, b.volumes)
    stray = bucket / "dicom" / "t1" / "STS-000" / "stray.dcm"
    stray.write_bytes(b"x")
    for mod in (timages, jimages):
        with pytest.raises(Exception, match="Unable to parse S3 key"):
            mod.build_manifest_dicom_s3("s3://bkt/dicom/t1/", dicom["key"])


def test_fetched_objects_are_removed_with_the_run_directory(
        s3, cohorts, tmp_path, monkeypatch):
    nifti, dicom = cohorts
    bucket = s3.root / "bkt"
    for pdir in sorted(Path(nifti["t1"]).iterdir()):
        _upload(pdir, bucket, "nifti/t1")
    _upload(dicom["t1"], bucket, "dicom/t1")
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    timages.remove_fetched()  # a directory of an earlier test lies elsewhere
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    records = (timages.build_manifest_s3("s3://bkt/nifti/t1", nifti["key"])
               + timages.build_manifest_dicom_s3("s3://bkt/dicom/t1/",
                                                 dicom["key"]))
    assert len(records) == 10
    fetched = [p for p in tmp.rglob("*") if p.is_file()]
    assert len(fetched) > 2 * len(records)
    timages.remove_fetched()
    assert list(tmp.iterdir()) == []


@pytest.mark.parametrize("survival,blend", [(True, True), (True, False),
                                            (False, False)])
def test_training_upload_keys_match_jax(s3, tmp_path, survival, blend):
    assert tstore.train_artifact_names(survival, blend) \
        == jstore.train_artifact_names(survival, blend)
    out = tmp_path / "out"
    out.mkdir()
    for local, _ in tstore.train_artifact_names(survival, blend):
        (out / local).write_text(local)
    keys = {}
    for mod in (tstore, jstore):
        s3.uploads.clear()
        assert mod.upload_artifacts("art", str(out),
                                    mod.train_artifact_names(survival, blend),
                                    "models/run1")
        keys[mod] = list(s3.uploads)
    assert keys[tstore] == keys[jstore] == [
        ("art", f"models/run1/{dest}")
        for _, dest in jstore.train_artifact_names(survival, blend)]
    assert (s3.root / "art" / "models" / "run1" / keys[tstore][0][1]
            .split("/")[-1]).exists()


def test_inference_uploads_its_predictions(s3, tmp_path):
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.data.loader import build_device_dataset
    from mmnn_sts_torch.infer.run import InferenceConfig, inference_survival
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state

    rng = np.random.default_rng(0)
    n = 12
    ds = build_device_dataset(
        np.arange(100, 100 + n), "cpu",
        clinical=rng.normal(size=(n, 11)).astype(np.float32),
        events=(rng.random((n, 2)) < 0.6).astype(np.float32),
        durations=rng.integers(1, 50, (n, 2)).astype(np.float32))
    torch.manual_seed(0)
    model = build_model(Config(), False, True, False, False)
    state = create_train_state(model, *make_optimizer(model.parameters(),
                                                      1e-2, 1, 1), seed=0)
    out = tmp_path / "out"
    out.mkdir()
    cfg = InferenceConfig(gradcam=False, output_dir=str(out),
                          bucket="preds", dest_prefix="models/inf")
    inference_survival(state, ds, cfg)
    assert s3.uploads == [("preds",
                           "models/inf/survival_model_predictions.csv")]
    assert (s3.root / "preds" / "models" / "inf"
            / "survival_model_predictions.csv").read_bytes() \
        == (out / "survival_model_predictions.csv").read_bytes()
    s3.uploads.clear()
    os.remove(out / "survival_model_predictions.csv")
    inference_survival(state, ds, InferenceConfig(
        gradcam=False, output_dir=str(out), bucket="preds",
        save_preds=False))
    assert s3.uploads == [] and not os.listdir(out)


def test_cli_trains_from_s3_and_uploads(s3, cohorts, tmp_path):
    from mmnn_sts_torch.cli import main

    nifti, _ = cohorts
    bucket = s3.root / "bkt"
    for modality in ("t1", "t2"):
        for pdir in sorted(Path(nifti[modality]).iterdir()):
            for f in pdir.iterdir():
                dest = bucket / "cohort" / modality / f.name
                dest.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(f, dest)
    shutil.copyfile(nifti["clinical"], bucket / "cohort" / "clinical.csv")
    shutil.copyfile(nifti["key"], bucket / "cohort" / "key.csv")
    cfg = {"Data": {"data_loc": "s3://bkt/cohort/clinical.csv",
                    "key_loc": "s3://bkt/cohort/key.csv",
                    "image_loc": "s3://bkt/cohort", "bucket": "art"},
           "ImageModel": {"name": "tinycnn", "spatial_size": [16] * 3},
           "Preprocessing": {"output_dir": "models/s3run"},
           "Hyperparameters": {"train_batch_size": 2}}
    uids = [int(u) for u in tstore.read_csv(nifti["clinical"])["MRN"]]
    splits = {"train": uids[:4], "val": uids[4:], "test": uids[4:]}
    for name, part in splits.items():
        (bucket / "cohort" / f"{name}.txt").write_text(
            "".join(f"{u}\n" for u in part))
        cfg["Preprocessing"][f"{name}_uid_location"] = \
            f"s3://bkt/cohort/{name}.txt"
    config = tmp_path / "config.json"
    config.write_text(json.dumps(cfg))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main(["--images", "--preop", "--survival", "--blend",
                   "--config", str(config), "--epochs", "1",
                   "--output_path", str(tmp_path / "out"),
                   "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    uploaded = [k for b, k in s3.uploads if b == "art"]
    written = [dest for local, dest in tstore.train_artifact_names(True, True)
               if (tmp_path / "out" / local).exists()]
    assert uploaded == [f"models/s3run/{d}" for d in written]
    assert "models/s3run/model.npz" in uploaded


def test_without_boto3_remote_paths_raise_as_in_jax(cohorts, monkeypatch,
                                                    tmp_path):
    nifti, _ = cohorts
    for mod in (tstore, jstore):
        monkeypatch.setattr(mod, "boto3", None)
        monkeypatch.setattr(mod, "HAVE_BOTO3", False)
    for mod in (tstore, jstore):
        with pytest.raises(RuntimeError, match="boto3"):
            with mod.open_remote("s3://bucket/key"):
                pass
        with pytest.raises(ValueError, match="not a valid S3 URI"):
            with mod.open_remote("/local/file"):
                pass
        fetch_args = (str(tmp_path),) if mod is tstore else ()
        with pytest.raises(RuntimeError, match="boto3"):
            mod.fetch_to_local("s3://bucket/key", *fetch_args)
        with pytest.raises(RuntimeError, match="boto3"):
            mod.list_prefix("s3://bucket/prefix")
        with pytest.raises(RuntimeError, match="boto3"):
            mod.load_uids_any("s3://bucket/uids.txt")
        assert mod.upload_artifacts("b", str(tmp_path), ["x"], "p") is False
        assert mod.fetch_to_local(nifti["key"], *fetch_args) == nifti["key"]
    with pytest.raises(RuntimeError, match="boto3"):
        tstore.read_csv("s3://bucket/clinical.csv")
    for mod in (timages, jimages):
        with pytest.raises(RuntimeError, match="boto3"):
            mod.build_image_cohort(["s3://bucket/t1"], nifti["key"])
