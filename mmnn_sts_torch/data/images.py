"""Image manifest building + host-side volume preprocessing (counterpart of
the JAX package's data/images.py: ``resize_volume`` and ``apply_mask``
45-96, ``PatientRecord`` 98-106, the manifests 109-357, ``_load_dicom_pair``
359-384, ``load_patient_volume`` 387-419, ``ImageCohort`` 422-433,
``build_segmentation_cohort`` 436-463 and ``build_manifest_any`` / ``build_image_cohort`` / ``_load_modality_volumes``
467-569).

    manifest ({NIfTI folders, DICOM series trees} x {local, s3://})
    -> decode image + mask -> mask multiply + zero-slice crop or fill
    -> resize each modality -> stack T1/T2 channels
    -> one (N, D, H, W, C) float32 cohort array, placed on the device once.

NIfTI records go through the C++ thread pool (``data/native.py``, built
from ``native/mmnn_native.cpp`` at first use); a patient the pool rejects
is decoded by the numpy path, which ``use_native=False`` takes for every
patient. DICOM records are decoded by ``data/dicom.py`` (the C++ frame
decoders where they take the stream, else the Python codecs) on a thread
pool. ``s3://`` objects are fetched to local files first
(``utils/store.py``, gated on boto3).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..exceptions import InitializationError
from ..utils.store import fetch_to_local, is_remote, list_prefix, read_csv
from . import native
from .nifti import load_nifti


def resize_volume(vol: np.ndarray, out_shape) -> np.ndarray:
    """Trilinear resize with half-pixel sampling (align_corners=False),
    axis by axis in float32."""
    vol = np.asarray(vol, dtype=np.float32)
    out = vol
    for axis, new in enumerate(out_shape):
        old = out.shape[axis]
        if old == new:
            continue
        scale = old / new
        centers = (np.arange(new) + 0.5) * scale - 0.5
        lo = np.floor(centers).astype(np.int64)
        frac = (centers - lo).astype(np.float32)
        lo_c = np.clip(lo, 0, old - 1)
        hi_c = np.clip(lo + 1, 0, old - 1)
        a = np.take(out, lo_c, axis=axis)
        b = np.take(out, hi_c, axis=axis)
        shape = [1] * out.ndim
        shape[axis] = new
        w = frac.reshape(shape)
        out = a * (1.0 - w) + b * w
    return out


def apply_mask(
    image: np.ndarray, mask: np.ndarray, zero_slices: str = "crop"
) -> np.ndarray:
    """Multiply by the segmentation mask, then crop or fill all-zero planes.

    zero_slices: "crop" drops any plane (in all three axes) that is
    entirely zero; "fill" sets those planes to image_max/2 (the survival
    path); "none" leaves them.
    """
    masked = np.asarray(image, dtype=np.float32) * np.asarray(mask, dtype=np.float32)
    if zero_slices == "none":
        return masked
    ax2 = np.all(masked == 0, axis=(0, 1))
    ax0 = np.all(masked == 0, axis=(1, 2))
    ax1 = np.all(masked == 0, axis=(0, 2))
    if zero_slices == "crop":
        masked = masked[:, :, ~ax2][~ax0, :, :][:, ~ax1, :]
        return masked
    if zero_slices == "fill":
        fill = masked.max() / 2.0
        masked[:, :, ax2] = fill
        masked[ax0, :, :] = fill
        masked[:, ax1, :] = fill
        return masked
    raise ValueError(f"Unknown zero_slices mode: {zero_slices}")


@dataclass
class PatientRecord:
    anon_id: str
    uid: int
    image_path: str
    mask_path: str
    # "nifti" (paths are files) or "dicom" (paths are series directories or
    # single multi-frame files)
    format: str = "nifti"


def _anon_id_from_dirname(name: str) -> str:
    anon = "-".join(name.split("-")[:2])
    return anon.replace("scan_", "").replace(".nii.gz", "")


def _cell_uid(v) -> int:
    return int(v.item()) if isinstance(v, np.generic) else int(float(v))


def _key_lookup(patient_key_csv: str):
    """``uid_of(*anon_ids)``: the uid of the first of the anon ids found in
    exactly one row of the patient key; raises naming the first if none
    is."""
    key = read_csv(patient_key_csv)
    anon_col = [str(a) for a in key[C.ANON_UID]]

    def uid_of(*anon_ids: str) -> int:
        for anon in anon_ids:
            rows = [i for i, a in enumerate(anon_col) if a == anon]
            if len(rows) == 1:
                return _cell_uid(key[C.UID][rows[0]])
        raise InitializationError(
            f"Could not find UID for patient {anon_ids[0]} - Ensure uid is "
            "in the patient key"
        )

    return uid_of


def _object_uri(prefix: str, key: str) -> str:
    """The URI of a listed ``key`` under ``prefix``: 's3://bucket/key' for
    's3://bucket/...', the key itself for a prefix without a scheme."""
    if "//" not in prefix:
        return key
    scheme, rest = prefix.split("//", 1)
    return f"{scheme}//{rest.split('/', 1)[0]}/{key}"


_fetch_root: str | None = None


def _fetch_dir() -> str:
    """The run's one temporary directory for fetched s3:// objects, made at
    first use and removed at interpreter exit, so a cohort's imaging data
    does not outlive the run."""
    global _fetch_root
    if _fetch_root is None:
        _fetch_root = tempfile.mkdtemp(prefix="mmnn_s3_")
        atexit.register(remove_fetched)
    return _fetch_root


def remove_fetched() -> None:
    """Delete every object fetched so far (the run's temporary directory);
    the next fetch makes a new one."""
    global _fetch_root
    if _fetch_root is not None:
        shutil.rmtree(_fetch_root, ignore_errors=True)
        atexit.unregister(remove_fetched)
        _fetch_root = None


def build_manifest_s3(prefix: str, patient_key_csv: str) -> list[PatientRecord]:
    """Records of an s3:// NIfTI prefix: the objects pair up per patient as
    (scan_*.nii(.gz) image, other NIfTI mask); the anon id is the scan's
    file name without 'scan_' and the extension, cut to its first two
    '-'-separated parts. Each object is fetched into the run's temporary
    directory (``_fetch_dir``), so decoding takes the local path."""
    groups: dict[str, dict] = {}
    for key in list_prefix(prefix):
        if not key.endswith((".nii", ".nii.gz")):
            continue
        fname = key.split("/")[-1]
        if fname.startswith("scan"):
            groups.setdefault(_anon_id_from_dirname(fname), {})["image"] = key
        else:
            anon = _anon_id_from_dirname(fname.replace("mask_", ""))
            groups.setdefault(anon, {})["mask"] = key

    uid_of = _key_lookup(patient_key_csv)
    records = []
    for anon in sorted(groups):
        pair = groups[anon]
        if "image" not in pair or "mask" not in pair:
            continue
        uid = uid_of(anon)
        records.append(PatientRecord(
            anon_id=anon, uid=uid,
            image_path=fetch_to_local(_object_uri(prefix, pair["image"]),
                                      _fetch_dir()),
            mask_path=fetch_to_local(_object_uri(prefix, pair["mask"]),
                                     _fetch_dir())))
    return records


def build_manifest(patient_directory: str, patient_key_csv: str) -> list[PatientRecord]:
    """Scan a local patient directory tree into (uid, image, mask) records:
    one folder per patient; inside, the file starting with 'scan' is the
    image and any other NIfTI is the mask. The folder name, truncated to
    its first two '-'-separated parts, is looked up in the patient key's
    'Anon MRN' column."""
    uid_of = _key_lookup(patient_key_csv)
    records = []
    for name in sorted(os.listdir(patient_directory)):
        if name.startswith("."):
            continue
        pdir = os.path.join(patient_directory, name)
        if not os.path.isdir(pdir):
            continue
        image_path, mask_path = None, None
        for fname in sorted(os.listdir(pdir)):
            full = os.path.join(pdir, fname)
            if fname.startswith("scan"):
                image_path = full
            elif fname.endswith((".nii", ".nii.gz")):
                mask_path = full
        if image_path is None or mask_path is None:
            continue
        anon = _anon_id_from_dirname(name)
        records.append(PatientRecord(anon_id=anon, uid=uid_of(anon),
                                     image_path=image_path,
                                     mask_path=mask_path))
    return records


def build_manifest_dicom(patient_directory: str,
                         patient_key_csv: str) -> list[PatientRecord]:
    """Records of a local DICOM tree: one folder per patient (named by its
    anon MRN) holding an entry whose name contains 'image' (a directory of
    one .dcm per slice) and one containing 'mask' (the DicomRT mask). The
    folder name is looked up as it is, then cut to two '-'-separated
    parts."""
    uid_of = _key_lookup(patient_key_csv)
    records = []
    for name in sorted(os.listdir(patient_directory)):
        if name.startswith("."):
            continue
        pdir = os.path.join(patient_directory, name)
        if not os.path.isdir(pdir):
            continue
        image_path = mask_path = None
        for entry in sorted(os.listdir(pdir)):
            low = entry.lower()
            if "image" in low:
                image_path = os.path.join(pdir, entry)
            elif "mask" in low:
                mask_path = os.path.join(pdir, entry)
        if image_path is None or mask_path is None:
            continue
        records.append(PatientRecord(
            anon_id=name, uid=uid_of(name, _anon_id_from_dirname(name)),
            image_path=image_path, mask_path=mask_path, format="dicom"))
    return records


def build_manifest_dicom_s3(prefix: str,
                            patient_key_csv: str) -> list[PatientRecord]:
    """Records of an s3:// DICOM prefix: the key's first path segment after
    the prefix is the patient's anon MRN; keys whose rest contains 'image'
    are its slices, 'mask' its mask, anything else raises. Each patient's
    objects are fetched into local image/ and mask/ directories under the
    run's temporary directory (``_fetch_dir``)."""
    bare = prefix.split("//", 1)[-1].split("/", 1)
    rel_prefix = bare[1] if "//" in prefix and len(bare) > 1 else prefix

    series: dict[str, dict[str, list[str]]] = {}
    for key in list_prefix(prefix):
        trunc = key[len(rel_prefix):] if key.startswith(rel_prefix) else key
        parts = [p for p in trunc.split("/") if p]
        if not parts:
            continue
        entry = series.setdefault(parts[0], {"image": [], "mask": []})
        if "image" in trunc:
            entry["image"].append(key)
        elif "mask" in trunc:
            entry["mask"].append(key)
        else:
            raise InitializationError(
                "Could not initialize S3 DICOM dataset - Unable to parse S3 "
                f"key {key}"
            )

    uid_of = _key_lookup(patient_key_csv)
    records = []
    for anon in sorted(series):
        pair = series[anon]
        if not pair["image"] or not pair["mask"]:
            continue
        pdir = tempfile.mkdtemp(prefix=f"dicom_{anon}_", dir=_fetch_dir())
        img_dir, mask_dir = (os.path.join(pdir, "image"),
                             os.path.join(pdir, "mask"))
        os.makedirs(img_dir)
        os.makedirs(mask_dir)
        for keys, dest in ((pair["image"], img_dir), (pair["mask"], mask_dir)):
            for k in keys:
                os.replace(fetch_to_local(_object_uri(prefix, k), dest),
                           os.path.join(dest, os.path.basename(k)))
        records.append(PatientRecord(
            anon_id=anon, uid=uid_of(anon, _anon_id_from_dirname(anon)),
            image_path=img_dir, mask_path=mask_dir, format="dicom"))
    return records


def _load_dicom_pair(rec: PatientRecord) -> tuple[np.ndarray, np.ndarray]:
    """A DICOM patient as (image, binary mask) on the image's grid: the mask
    resampled through physical space (origin, spacing, orientation,
    per-frame z offsets: ``dicom.resample_to_grid``, as
    ``sitk.Resample(mask, image)`` does), then binarised at > 128. Where a
    series lacks geometry tags, a mask of the image's shape is taken as
    it is and any other is resized trilinearly."""
    from .dicom import load_dicom_series, resample_to_grid

    image, igeom = load_dicom_series(rec.image_path, with_geometry=True)
    mask, mgeom = load_dicom_series(rec.mask_path, with_geometry=True)
    image = image.astype(np.float32)
    mask = mask.astype(np.float32)
    if igeom is not None and mgeom is not None:
        mask = resample_to_grid(mask, mgeom, image.shape, igeom)
    elif mask.shape != image.shape:
        mask = resize_volume(mask, image.shape)
    return image, (mask > 128).astype(np.float32)


def load_patient_volume(
    rec: PatientRecord,
    spatial_size=C.SPATIAL_SIZE,
    zero_slices: str = "fill",
) -> np.ndarray:
    """Decode + mask + crop/fill + resize one patient to ``spatial_size``:
    a NIfTI patient on the numpy path (the C++ pool of
    ``_load_modality_volumes`` falls back to it), a DICOM patient through
    ``data/dicom.py``."""
    if rec.format == "dicom":
        image, mask = _load_dicom_pair(rec)
    else:
        image = load_nifti(rec.image_path, dtype=np.float32)
        mask = load_nifti(rec.mask_path, dtype=np.float32)
    masked = apply_mask(image, mask, zero_slices=zero_slices)
    if any(s == 0 for s in masked.shape):
        # Fully-masked-out volume after cropping; fall back to zeros.
        return np.zeros(spatial_size, dtype=np.float32)
    return resize_volume(masked, spatial_size)


@dataclass
class ImageCohort:
    """All image volumes for a cohort, as one host array ready for device."""

    uids: np.ndarray  # (N,)
    volumes: np.ndarray  # (N, D, H, W, C) float32


def build_segmentation_cohort(
    patient_directory: str,
    patient_key_csv: str,
    spatial_size=C.SPATIAL_SIZE,
) -> tuple[ImageCohort, ImageCohort]:
    """(images, masks) cohorts for segmentation (images.py:436-463): each
    record of the local NIfTI manifest, image and mask read as float32 and
    resized to ``spatial_size`` by the numpy path, the mask binarised again
    at 0.5; both (N, *spatial, 1) with the same uids. No training loop
    reads them, in either package."""
    records = build_manifest(patient_directory, patient_key_csv)
    imgs, masks, uids = [], [], []
    for rec in records:
        image = load_nifti(rec.image_path, dtype=np.float32)
        mask = load_nifti(rec.mask_path, dtype=np.float32)
        imgs.append(resize_volume(image, spatial_size)[..., None])
        masks.append((resize_volume(mask, spatial_size) > 0.5).astype(
            np.float32)[..., None])
        uids.append(rec.uid)
    uids = np.asarray(uids, dtype=np.int64)
    return (
        ImageCohort(uids=uids, volumes=np.stack(imgs).astype(np.float32)),
        ImageCohort(uids=uids, volumes=np.stack(masks).astype(np.float32)),
    )


def build_manifest_any(directory: str, patient_key_csv: str,
                       image_format: str = "nifti") -> list[PatientRecord]:
    """Manifest dispatch: {nifti, dicom} x {local, s3://} -> records."""
    if image_format == "dicom":
        if is_remote(directory):
            return build_manifest_dicom_s3(directory, patient_key_csv)
        return build_manifest_dicom(directory, patient_key_csv)
    if is_remote(directory):
        return build_manifest_s3(directory, patient_key_csv)
    return build_manifest(directory, patient_key_csv)


def build_image_cohort(
    directories,
    patient_key_csv: str,
    spatial_size=C.SPATIAL_SIZE,
    zero_slices: str = "fill",
    image_format: str = "nifti",
    use_native: bool = True,
) -> ImageCohort:
    """The (N, *spatial, C) cohort array: each directory (one per modality,
    e.g. T1 and T2; local or s3://, NIfTI folders or DICOM trees by
    ``image_format``) is resized on its own and the modalities are stacked
    on the channel axis, over the patients all modalities have.
    ``use_native=False`` decodes every NIfTI patient by the numpy path."""
    if isinstance(directories, (str, os.PathLike)):
        directories = [directories]
    manifests = [build_manifest_any(str(d), patient_key_csv, image_format)
                 for d in directories]

    common = set.intersection(*[{r.anon_id for r in m} for m in manifests])
    by_anon = [{r.anon_id: r for r in m} for m in manifests]
    anon_ids = sorted(common)

    per_modality = [
        _load_modality_volumes([by_anon[m][anon] for anon in anon_ids],
                               spatial_size, zero_slices, use_native)
        for m in range(len(manifests))
    ]
    return ImageCohort(
        uids=np.asarray([by_anon[0][a].uid for a in anon_ids], dtype=np.int64),
        volumes=np.stack(per_modality, axis=-1).astype(np.float32),
    )


def _load_modality_volumes(records, spatial_size, zero_slices,
                           use_native: bool = True) -> np.ndarray:
    """One modality's records as an (N, *spatial) array. NIfTI records go
    through the C++ thread pool (GIL-free decode, mask and resize); a
    patient it rejects is decoded by the numpy path, as is every patient
    with ``use_native=False``. DICOM records are decoded on a thread pool
    (the C++ frame decoders and numpy release the GIL)."""
    out: list = [None] * len(records)

    nifti_idx = [i for i, r in enumerate(records) if r.format != "dicom"]
    if nifti_idx and use_native:
        vols, errors = native.preprocess_cohort_native(
            [records[i].image_path for i in nifti_idx],
            [records[i].mask_path for i in nifti_idx],
            zero_slices, spatial_size)
        for j, i in enumerate(nifti_idx):
            if errors[j] == 0:
                out[i] = vols[j]

    dicom_idx = [i for i, r in enumerate(records) if r.format == "dicom"]
    if len(dicom_idx) > 1:
        with ThreadPoolExecutor() as ex:
            for i, v in zip(dicom_idx, ex.map(
                    lambda i: load_patient_volume(records[i], spatial_size,
                                                  zero_slices), dicom_idx)):
                out[i] = v

    for i, v in enumerate(out):  # numpy fallback / serial remainder
        if v is None:
            out[i] = load_patient_volume(records[i], spatial_size,
                                         zero_slices)
    return np.stack(out, axis=0)
