"""The port's DICOM reader and DICOM cohort build (``data/dicom.py``,
``data/images.py``) held against the JAX package's, on files written by
tests/fixtures.py's DICOM writers from a seed with numpy.

* ``read_dicom_file`` (every parsed field and the decoded pixels) and
  ``load_dicom_series`` (volume and geometry) agree bit for bit on explicit
  and implicit VR little endian series, rescaled slices, multiframe masks,
  deflated and big-endian files, and the compressed syntaxes (RLE, JPEG
  Lossless, JPEG-LS lossless and NEAR, JPEG 2000 5/3 and 9/7, lossy JPEG
  8 and 12 bit; frames of 16 x 16 or smaller), including signed 8-bit
  words (BitsAllocated decides the sign extension, not the decoder's
  dtype).
* ``resample_to_grid`` and ``_load_dicom_pair`` agree bit for bit on a
  same-grid mask, a shifted-origin mask, a z-reversed multiframe mask and
  a mask at a coarser in-plane spacing.
* ``build_manifest_dicom`` gives the JAX package's records, and a t1t2
  DICOM cohort (four patients' series compressed, one syntax each) equals
  the JAX package's ``build_image_cohort(..., image_format="dicom")`` bit
  for bit, with the compressed frames decoded by the C++ decoders.
* The CLI on a DICOM cohort (``Data.image_format: dicom``, TinyDenseNet at
  16^3, 2 epochs) beside the JAX CLI on the same cohort, compared in kind
  as tests/test_torch_cli.py compares the NIfTI run.
* A subprocess with pandas, matplotlib, yaml, jax, flax, optax and the JAX
  package blocked builds the DICOM cohort from a JSON config.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import fixtures as fx
from mmnn_sts_torch.data import dicom as tdicom
from mmnn_sts_torch.data import images as timages
from mmnn_sts_torch.data import native
from mmnn_sts_tpu.data import dicom as jdicom
from mmnn_sts_tpu.data import images as jimages
from test_torch_cli import _in_dir, _rows, run_jax_cli
from test_torch_data import run_blocked

torch.set_num_threads(1)

N_CLI, SIDE = 23, 16


def _pixels(seed, shape, lo, hi):
    return np.random.default_rng(seed).integers(lo, hi, shape)


def _series(d, writer, vol, **kw):
    """One file a slice of ``vol`` in directory ``d``, written out of
    order (the reader sorts by position)."""
    os.makedirs(d)
    for k in reversed(range(vol.shape[0])):
        writer(os.path.join(d, f"s{k:03d}.dcm"), vol[k], instance=k + 1,
               z=2.0 * k, **kw)
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> a .dcm file or a series directory."""
    root = tmp_path_factory.mktemp("dicom")
    out = {}
    geo = dict(pixel_spacing=(0.75, 0.5))
    vol16 = _pixels(1, (4, 10, 12), -300, 900).astype(np.int16)
    out["explicit"] = _series(str(root / "explicit"), fx.write_dicom_slice,
                              vol16, explicit=True, origin_xy=(1.0, -2.0),
                              **geo)
    out["implicit"] = _series(str(root / "implicit"), fx.write_dicom_slice,
                              vol16, explicit=False, **geo)
    out["no_geometry"] = _series(str(root / "nogeo"), fx.write_dicom_slice,
                                 vol16)
    out["rescaled"] = _series(str(root / "rescaled"), fx.write_dicom_slice,
                              vol16, slope=2.5, inter=-100.0, **geo)
    unsigned = _pixels(2, (3, 16, 16), 0, 4096)
    out["rle16"] = _series(str(root / "rle16"), fx.write_dicom_rle,
                           unsigned.astype(np.uint16), **geo)
    # signed 8-bit words: 0xFF must come back as -1
    s8 = _pixels(3, (2, 9, 7), -128, 128)
    s8[0, 0, 0] = -1
    out["rle8_signed"] = _series(str(root / "rle8s"), fx.write_dicom_rle,
                                 s8.astype(np.int8).view(np.uint8),
                                 bits=8, signed=True)
    out["jpeg_ls8_signed"] = _series(
        str(root / "jls8s"), fx.write_dicom_jpeg_ls,
        s8.astype(np.int8).view(np.uint8).astype(np.int64), bits=8,
        signed=True)
    out["jpeg_lossless"] = _series(str(root / "jll"),
                                   fx.write_dicom_jpeg_lossless, unsigned,
                                   predictor=5, **geo)
    out["jpeg_lossless_fragments"] = str(root / "jll_frag.dcm")
    fx.write_dicom_jpeg_lossless(out["jpeg_lossless_fragments"],
                                 unsigned[0], n_fragments=3)
    out["jpeg_lossless_multiframe"] = str(root / "jll_mf.dcm")
    fx.write_dicom_jpeg_lossless(out["jpeg_lossless_multiframe"], unsigned,
                                 frames=True)
    out["jpeg_ls"] = _series(str(root / "jls"), fx.write_dicom_jpeg_ls,
                             unsigned, bits=16, **geo)
    out["jpeg_ls_near"] = _series(str(root / "jlsn"), fx.write_dicom_jpeg_ls,
                                  unsigned, bits=16, near=3)
    out["j2k"] = _series(str(root / "j2k"), fx.write_dicom_j2k, unsigned,
                         bits=16, **geo)
    out["j2k_97"] = _series(str(root / "j2k97"), fx.write_dicom_j2k,
                            unsigned, bits=16, irreversible=True, qdrop=1,
                            syntax=tdicom.J2K)
    out["j2k_multiframe"] = str(root / "j2k_mf.dcm")
    fx.write_dicom_j2k(out["j2k_multiframe"], unsigned, frames=True, bits=16)
    out["jpeg_baseline"] = _series(str(root / "jpg8"),
                                   fx.write_dicom_jpeg_baseline,
                                   _pixels(4, (2, 13, 11), 0, 256), bits=8)
    out["jpeg_extended"] = _series(str(root / "jpg12"),
                                   fx.write_dicom_jpeg_baseline,
                                   _pixels(5, (2, 16, 10), 0, 4096), bits=12,
                                   quant=2)
    out["deflated"] = _series(str(root / "deflated"), fx.write_dicom_deflated,
                              vol16, **geo)
    out["big_endian"] = _series(str(root / "big_endian"),
                                fx.write_dicom_big_endian, vol16, **geo)
    mask = np.zeros((4, 10, 12), np.int16)
    mask[1:3, 2:7, 3:9] = 255
    out["multiframe"] = str(root / "mask.dcm")
    fx.write_dicom_multiframe(out["multiframe"], mask, position=(1.0, -2.0,
                                                                 0.0),
                              grid_offsets=[0, 2, 4, 6], **geo)
    out["multiframe_shifted"] = str(root / "mask_shifted.dcm")
    fx.write_dicom_multiframe(out["multiframe_shifted"], mask,
                              position=(1.0, -2.0, 2.0),
                              grid_offsets=[0, 2, 4, 6], **geo)
    out["multiframe_zreversed"] = str(root / "mask_zrev.dcm")
    fx.write_dicom_multiframe(out["multiframe_zreversed"], mask,
                              position=(1.0, -2.0, 6.0),
                              grid_offsets=[0, -2, -4, -6], **geo)
    out["multiframe_coarse"] = str(root / "mask_coarse.dcm")
    fx.write_dicom_multiframe(out["multiframe_coarse"], mask[:, ::2, ::2],
                              position=(1.0, -2.0, 0.0),
                              pixel_spacing=(1.5, 1.0),
                              grid_offsets=[0, 2, 4, 6])
    out["multiframe_no_geometry"] = str(root / "mask_nogeo.dcm")
    fx.write_dicom_multiframe(out["multiframe_no_geometry"], mask)
    return out


SERIES = ["explicit", "implicit", "no_geometry", "rescaled", "rle16",
          "rle8_signed", "jpeg_ls8_signed", "jpeg_lossless",
          "jpeg_lossless_fragments", "jpeg_lossless_multiframe", "jpeg_ls",
          "jpeg_ls_near", "j2k", "j2k_97", "j2k_multiframe", "jpeg_baseline",
          "jpeg_extended", "deflated", "big_endian", "multiframe",
          "multiframe_shifted", "multiframe_zreversed", "multiframe_coarse",
          "multiframe_no_geometry"]
MASKS = ["multiframe", "multiframe_shifted", "multiframe_zreversed",
         "multiframe_coarse"]
FIELDS = ("rows", "cols", "bits_allocated", "pixel_representation",
          "rescale_slope", "rescale_intercept", "instance_number",
          "number_of_frames", "position", "orientation", "pixel_spacing",
          "spacing_between_slices", "grid_frame_offsets", "pixel_data",
          "fragments", "transfer_syntax", "extra")


def _first_file(path):
    if os.path.isfile(path):
        return path
    return os.path.join(path, sorted(os.listdir(path))[0])


def _same_geometry(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for name in ("origin", "row_dir", "col_dir", "pixel_spacing",
                 "z_offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("name", SERIES)
def test_read_dicom_file_matches_jax(files, name):
    path = _first_file(files[name])
    got, want = tdicom.read_dicom_file(path), jdicom.read_dicom_file(path)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    g, w = tdicom._slice_array(got), jdicom._slice_array(want)
    assert g.dtype == w.dtype == np.float32
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", SERIES)
def test_load_dicom_series_matches_jax(files, name):
    native.reset_counts()
    got, ggeom = tdicom.load_dicom_series(files[name], with_geometry=True)
    want, wgeom = jdicom.load_dicom_series(files[name], with_geometry=True)
    assert got.dtype == want.dtype and got.ndim == 3
    np.testing.assert_array_equal(got, want)
    _same_geometry(ggeom, wgeom)
    assert native.counts["frame_fallbacks"] == 0
    if name.startswith(("jpeg_ls", "jpeg_lossless", "j2k")):
        kind = ("jpeg_ls" if name.startswith("jpeg_ls") else
                "jpeg_lossless" if name.startswith("jpeg_lossless")
                else "j2k")
        assert native.counts[f"{kind}_frames"] == got.shape[0]
    if name in ("rle8_signed", "jpeg_ls8_signed"):
        assert got[0, 0, 0] == -1.0 and got.min() < 0


@pytest.mark.parametrize("mask", MASKS)
def test_resample_to_grid_and_dicom_pair_match_jax(files, mask):
    image, igeom = tdicom.load_dicom_series(files["explicit"],
                                            with_geometry=True)
    mvol, mgeom = tdicom.load_dicom_series(files[mask], with_geometry=True)
    got = tdicom.resample_to_grid(mvol, mgeom, image.shape, igeom)
    want = jdicom.resample_to_grid(mvol, mgeom, image.shape, igeom)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got > 128).any()
    if mask == "multiframe":
        np.testing.assert_array_equal(got, mvol)  # the same grid
    pair = dict(anon_id="a", uid=1, image_path=files["explicit"],
                mask_path=files[mask], format="dicom")
    g_img, g_mask = timages._load_dicom_pair(timages.PatientRecord(**pair))
    w_img, w_mask = jimages._load_dicom_pair(jimages.PatientRecord(**pair))
    np.testing.assert_array_equal(g_img, w_img)
    np.testing.assert_array_equal(g_mask, w_mask)


def test_resample_refuses_crossed_orientations():
    grid = dict(origin=np.zeros(3), pixel_spacing=(1, 1),
                z_offsets=np.arange(4.0))
    a, b = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
    for mod in (tdicom, jdicom):
        with pytest.raises(ValueError, match="orientation"):
            mod.resample_to_grid(
                np.zeros((4, 4, 4), np.float32),
                mod.SeriesGeometry(row_dir=b, col_dir=a, **grid), (4, 4, 4),
                mod.SeriesGeometry(row_dir=a, col_dir=b, **grid))


COMPRESSED = ((0, "t1", fx.write_dicom_jpeg_ls, {}),
              (1, "t2", fx.write_dicom_rle, {}),
              (2, "t1", fx.write_dicom_j2k, {}),
              (3, "t2", fx.write_dicom_jpeg_lossless, {}))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The CLI tests' DICOM cohort (23 patients, 12 x 14 x 12 series);
    patients 0-3 have one modality's series compressed, one syntax each."""
    root = str(tmp_path_factory.mktemp("dicom_cohort"))
    paths, uids = fx.make_dicom_cohort(root, n=N_CLI)
    anon = sorted(os.listdir(paths["t1"]))
    for i, modality, writer, kw in COMPRESSED:
        image_dir = os.path.join(paths[modality], anon[i], "image")
        vol = tdicom.load_dicom_series(image_dir).astype(np.int64)
        shutil.rmtree(image_dir)
        _series(image_dir, writer, vol, **kw)
    return paths, uids


def test_build_manifest_dicom_matches_jax(cohort):
    paths, uids = cohort
    for modality in ("t1", "t2"):
        got = timages.build_manifest_dicom(paths[modality], paths["key"])
        want = jimages.build_manifest_dicom(paths[modality], paths["key"])
        assert [vars(r) for r in got] == [vars(r) for r in want]
        assert sorted(r.uid for r in got) == sorted(int(u) for u in uids)


def test_t1t2_dicom_cohort_matches_jax(cohort):
    paths, _ = cohort
    dirs = (paths["t1"], paths["t2"])
    native.reset_counts()
    got = timages.build_image_cohort(dirs, paths["key"], (SIDE,) * 3, "fill",
                                     image_format="dicom")
    counts = dict(native.counts)
    want = jimages.build_image_cohort(dirs, paths["key"], (SIDE,) * 3,
                                      "fill", image_format="dicom")
    np.testing.assert_array_equal(got.uids, want.uids)
    assert got.volumes.shape == (N_CLI,) + (SIDE,) * 3 + (2,)
    np.testing.assert_array_equal(got.volumes, want.volumes)
    # 12 slices of each compressed series through the C++ decoders
    assert counts["jpeg_ls_frames"] == counts["j2k_frames"] == 12
    assert counts["jpeg_lossless_frames"] == 12
    assert counts["frame_fallbacks"] == counts["native_patients"] == 0


@pytest.fixture(scope="module")
def runs(cohort, tmp_path_factory):
    """The survival CLI on the DICOM cohort in both packages, from the same
    initial weights (as tests/test_torch_cli.py's runs)."""
    from mmnn_sts_torch.cli import main as port_main
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.checkpoint import save_params_npz

    paths, _ = cohort
    root = tmp_path_factory.mktemp("dicom_cli")
    cfg = {"Data": {"data_loc": paths["clinical"], "image_loc": paths["root"],
                    "key_loc": paths["key"], "image_format": "dicom"},
           "ImageModel": {"name": "tinydensenet",
                          "spatial_size": [SIDE] * 3},
           "Hyperparameters": {"epochs": 2, "train_batch_size": 4,
                               "learning_rate": 0.002, "seed": 42}}
    config = root / "config.json"
    config.write_text(json.dumps(cfg))
    torch.manual_seed(0)
    init = root / "init.npz"
    save_params_npz(str(init), build_model(parse_config(str(config)), True,
                                           True, False, True))
    common = ["--images", "--preop", "--survival", "--blend", "--split",
              "--epochs", "2", "--blend_update_interval", "1", "--config",
              str(config), "--weights", str(init)]
    dirs = {name: root / name for name in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    run_jax_cli(common + ["--output_path", str(dirs["jax"] / "out")],
                dirs["jax"])
    assert _in_dir(port_main, common + ["--output_path",
                                        str(dirs["port"] / "out"),
                                        "--device", "cpu"], dirs["port"]) == 0
    return dict(config=config, init=init, **dirs)


def test_dicom_cli_run_matches_jax_in_kind(runs):
    for name in ("train_uids.txt", "val_uids.txt", "test_uids.txt"):
        assert (runs["port"] / name).read_text() == \
            (runs["jax"] / name).read_text()
    got, want = _rows(runs["port"] / "out"), _rows(runs["jax"] / "out")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert (g["kind"], g["epoch"]) == (w["kind"], w["epoch"])
        for key in ("train_loss", "val_loss", "selection_loss"):
            assert np.isfinite(g[key]), key
        for key in ("train_c", "val_c"):
            assert 0.0 <= g[key] <= 1.0, key
    best = runs["port"] / "out" / "best_surv_model.npz"
    with np.load(best) as g, \
            np.load(runs["jax"] / "out" / "best_surv_model.npz") as w, \
            np.load(runs["init"]) as init:
        assert sorted(g.files) == sorted(w.files)
        for k in g.files:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        assert not np.array_equal(g["params/output_head/kernel"],
                                  init["params/output_head/kernel"])
    blend = [np.loadtxt(runs[n] / "out" / "gblend_weights_history.csv",
                        delimiter=",") for n in ("port", "jax")]
    assert blend[0].shape == blend[1].shape == (3, 3)
    np.testing.assert_array_equal(blend[0][0], blend[1][0])


def test_dicom_cohort_builds_without_pandas_yaml_or_jax(cohort, tmp_path):
    paths, _ = cohort
    cfg = {"Data": {"data_loc": paths["clinical"], "image_loc": paths["root"],
                    "key_loc": paths["key"], "image_format": "dicom"},
           "ImageModel": {"name": "tinydensenet",
                          "spatial_size": [SIDE] * 3}}
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    run_blocked(
        "from mmnn_sts_torch.config import parse_config\n"
        "from mmnn_sts_torch.data import native\n"
        "from mmnn_sts_torch.pipeline import TaskFlags, load_cohort\n"
        f"cfg = parse_config({str(cfg_path)!r})\n"
        "bundle = load_cohort(cfg, TaskFlags(images=True, preop=True,\n"
        "                                    survival=True))\n"
        f"assert bundle.images.volumes.shape == ({N_CLI},) + ({SIDE},) * 3"
        " + (2,)\n"
        "assert native.counts['j2k_frames'] == 12\n"
        "print('ok')\n",
        str(tmp_path))
