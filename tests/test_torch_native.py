"""The host C++ library of the port's cohort build (``data/native.py``, built
from ``native/mmnn_native.cpp`` by ``kernels/build.build_host``) held
against the port's numpy and Python paths.

* The library builds with g++ into ``kernels/_build/`` under a name that
  hashes its source and flags; a build whose source is missing raises with
  the compiler's log, and nothing falls back.
* Its NIfTI decode, ``preprocess_patient`` and ``preprocess_cohort``
  against ``data/nifti.load_nifti`` and ``images.apply_mask`` +
  ``resize_volume``, at tests/test_native.py's tolerances (rtol 1e-6 for a
  decode, 1e-4 for the resize, 1e-5 for the cohort).
* The C++ JPEG-LS, JPEG-Lossless and JPEG 2000 decoders equal the port's
  Python decoders bit for bit, each decoded frame counted; a truncated
  stream is handed to the Python decoder (counted as a frame fallback),
  which raises ValueError.
* A NIfTI variant the pool rejects (a .nii.gz of two gzip members: the C++
  inflate stops after the first) is decoded by the numpy path, per
  patient, and counted; the rest of the cohort stays in the pool.
"""

import gzip

import numpy as np
import pytest
import torch

from fixtures import make_image_tree, make_patient_key
from mmnn_sts_torch.data import images, native, nifti
from mmnn_sts_torch.data import jpeg2000, jpeg_lossless, jpeg_ls
from mmnn_sts_torch.kernels import build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    return native._load()


def _save(tmp_path, name, arr):
    path = str(tmp_path / name)
    nifti.save_nifti(path, arr)
    return path


def test_library_builds_into_the_build_directory(lib):
    path = build.build_host("mmnn_native")
    assert path.parent == build.BUILD_DIR and path.exists()
    assert path.name.startswith("libmmnn_native-") and path.suffix == ".so"
    assert path == build.host_library_path("mmnn_native")
    assert lib is native._load()
    for fn in ("mmnn_nifti_read", "mmnn_preprocess_cohort",
               "mmnn_jpeg_ls_decode", "mmnn_jpeg_lossless_decode",
               "mmnn_j2k_decode"):
        assert hasattr(lib, fn)


def test_a_failed_build_raises_with_the_compiler_log(tmp_path,
                                                     monkeypatch):
    missing = tmp_path / "no_such_source.cpp"
    monkeypatch.setitem(build.HOST_SOURCES, "mmnn_native_missing", missing)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="no_such_source.cpp") as err:
        build.build_host("mmnn_native_missing")
    assert "exited" in str(err.value)
    lib = build.host_library_path("mmnn_native_missing")
    assert lib.parent == tmp_path / "_build" and not lib.exists()


@pytest.mark.parametrize("name", ["v.nii.gz", "v.nii"])
def test_nifti_decode_matches_numpy(tmp_path, lib, name):
    arr = (np.random.default_rng(1).normal(size=(11, 9, 14)) * 100
           ).astype(np.float32)
    path = _save(tmp_path, name, arr)
    got = native.load_nifti_native(path)
    assert got.dtype == np.float32 and got.shape == arr.shape
    np.testing.assert_allclose(got, nifti.load_nifti(path), rtol=1e-6)
    np.testing.assert_allclose(got, arr, rtol=1e-6)


@pytest.mark.parametrize("mode", ["crop", "fill", "none"])
def test_preprocess_patient_matches_numpy(tmp_path, lib, mode):
    rng = np.random.default_rng(2)
    shape = (17, 13, 19)
    img = (rng.normal(size=shape) ** 2 * 300).astype(np.float32)
    mask = np.zeros(shape, dtype=np.float32)
    mask[3:-4, 2:-2, 5:-3] = 1.0
    pi, pm = _save(tmp_path, "i.nii.gz", img), _save(tmp_path, "m.nii.gz",
                                                      mask)
    native.reset_counts()
    got = native.preprocess_patient_native(pi, pm, mode, (12, 12, 12))
    want = images.resize_volume(images.apply_mask(img, mask, mode),
                                (12, 12, 12))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert native.counts["native_patients"] == 1
    with pytest.raises(IOError):
        native.preprocess_patient_native(pi, str(tmp_path / "nope.nii"),
                                         mode, (12, 12, 12))
    assert native.counts["patient_fallbacks"] == 1


def test_preprocess_cohort_matches_single_patients(tmp_path, lib):
    rng = np.random.default_rng(3)
    imgs, masks = [], []
    for i in range(5):
        shape = (10 + i, 12, 9)
        imgs.append(_save(tmp_path, f"i{i}.nii.gz",
                          (rng.normal(size=shape) ** 2 * 50).astype(
                              np.float32)))
        masks.append(_save(tmp_path, f"m{i}.nii.gz",
                           np.ones(shape, np.float32)))
    vols, errors = native.preprocess_cohort_native(imgs, masks, "fill",
                                                   (8, 7, 6), num_threads=3)
    assert vols.shape == (5, 8, 7, 6) and not errors.any()
    for i in range(5):
        np.testing.assert_allclose(
            vols[i], native.preprocess_patient_native(imgs[i], masks[i],
                                                      "fill", (8, 7, 6)),
            rtol=1e-6)


def _frames():
    rng = np.random.default_rng(4)
    y, x = np.mgrid[:16, :16]
    img = np.clip(2000 + 1500 * np.sin(x / 3) * np.cos(y / 5)
                  + rng.normal(0, 40, (16, 16)), 0, 4095).astype(np.int64)
    return [
        ("jpeg_ls", jpeg_ls.encode_jpeg_ls(img, 12),
         native.jpeg_ls_decode_native, jpeg_ls.decode_jpeg_ls),
        ("jpeg_ls", jpeg_ls.encode_jpeg_ls(img, 12, near=2),
         native.jpeg_ls_decode_native, jpeg_ls.decode_jpeg_ls),
        ("jpeg_lossless", jpeg_lossless.encode_jpeg_lossless_sv1(img, 16),
         native.jpeg_lossless_decode_native,
         jpeg_lossless.decode_jpeg_lossless),
        ("jpeg_lossless",
         jpeg_lossless.encode_jpeg_lossless_sv1(img, 16, predictor=7),
         native.jpeg_lossless_decode_native,
         jpeg_lossless.decode_jpeg_lossless),
        ("j2k", jpeg2000.encode_j2k(img, 12), native.j2k_decode_native,
         jpeg2000.decode_j2k),
        ("j2k", jpeg2000.encode_j2k(img - 2048, 12, signed=True),
         native.j2k_decode_native, jpeg2000.decode_j2k),
        ("j2k", jpeg2000.encode_j2k(img, 12, irreversible=True, qdrop=1),
         native.j2k_decode_native, jpeg2000.decode_j2k),
    ]


@pytest.mark.parametrize("case", range(7))
def test_frame_decoders_match_python(lib, case):
    name, blob, fast, slow = _frames()[case]
    native.reset_counts()
    got = fast(blob, 16, 16)
    want = slow(blob)
    assert got is not None and got.shape == (16, 16)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))
    assert native.counts[f"{name}_frames"] == 1
    assert native.counts["frame_fallbacks"] == 0
    with pytest.raises(ValueError, match="DICOM says 17x16"):
        fast(blob, 17, 16)


@pytest.mark.parametrize("case", [0, 4])
def test_a_truncated_frame_goes_to_python_and_raises(lib, case):
    _, blob, fast, slow = _frames()[case]
    native.reset_counts()
    assert fast(blob[:len(blob) // 2], 16, 16) is None
    assert native.counts["frame_fallbacks"] == 1
    with pytest.raises(ValueError):
        slow(blob[:len(blob) // 2])


def test_rejected_nifti_falls_back_per_patient(tmp_path, lib):
    uids = [201, 202, 203, 204]
    key = str(tmp_path / "key.csv")
    anon = make_patient_key(key, uids)
    root = tmp_path / "t1"
    make_image_tree(str(root), anon, shape=(14, 12, 10))
    # patient 1's image as a .nii.gz of two gzip members: the numpy reader
    # reads both, the C++ inflate only the first (too few voxels)
    scan = next((root / anon[1]).glob("scan_*"))
    raw = gzip.decompress(scan.read_bytes())
    cut = len(raw) // 2
    scan.write_bytes(gzip.compress(raw[:cut]) + gzip.compress(raw[cut:]))
    assert nifti.load_nifti(str(scan), np.float32).shape == (14, 12, 10)
    with pytest.raises(IOError):
        native.load_nifti_native(str(scan))

    native.reset_counts()
    got = images.build_image_cohort(str(root), key, (8, 8, 8), "fill")
    assert native.counts["native_patients"] == 3
    assert native.counts["patient_fallbacks"] == 1
    plain = images.build_image_cohort(str(root), key, (8, 8, 8), "fill",
                                      use_native=False)
    np.testing.assert_array_equal(got.volumes[1], plain.volumes[1])
    np.testing.assert_allclose(got.volumes, plain.volumes, rtol=1e-5,
                               atol=1e-5)
    native.reset_counts()
    images.build_image_cohort(str(root), key, (8, 8, 8), "fill",
                              use_native=False)
    assert native.counts["native_patients"] == 0
