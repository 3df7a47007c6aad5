"""Image manifest building + host-side volume preprocessing (counterpart of
the JAX package's data/images.py: ``resize_volume`` and ``apply_mask``
45-96, ``PatientRecord`` 98-106, ``build_manifest`` 186-228,
``load_patient_volume`` 387-419, ``ImageCohort`` 422-433 and
``build_image_cohort`` 482-569).

    patient folders -> decode NIfTI image + mask -> mask multiply +
    zero-slice crop or fill -> resize each modality -> stack T1/T2 channels
    -> one (N, D, H, W, C) float32 cohort array, placed on the device once.

Local NIfTI only, decoded by the numpy path (``load_patient_volume`` with
``use_native=False`` in the JAX package). DICOM trees and ``s3://``
prefixes raise ``ConfigurationError``; they and the JAX package's C++
cohort pool are listed in ROADMAP.md.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..exceptions import ConfigurationError, InitializationError
from ..utils.store import is_remote, read_csv
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


def _anon_id_from_dirname(name: str) -> str:
    anon = "-".join(name.split("-")[:2])
    return anon.replace("scan_", "").replace(".nii.gz", "")


def _cell_uid(v) -> int:
    return int(v.item()) if isinstance(v, np.generic) else int(float(v))


def build_manifest(patient_directory: str, patient_key_csv: str) -> list[PatientRecord]:
    """Scan a local patient directory tree into (uid, image, mask) records:
    one folder per patient; inside, the file starting with 'scan' is the
    image and any other NIfTI is the mask. The folder name, truncated to
    its first two '-'-separated parts, is looked up in the patient key's
    'Anon MRN' column."""
    key = read_csv(patient_key_csv)
    anon_col = [str(a) for a in key[C.ANON_UID]]
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
        rows = [i for i, a in enumerate(anon_col) if a == anon]
        if len(rows) != 1:
            raise InitializationError(
                f"Could not find UID for patient {anon} - Ensure uid is in the "
                "patient key"
            )
        records.append(
            PatientRecord(
                anon_id=anon,
                uid=_cell_uid(key[C.UID][rows[0]]),
                image_path=image_path,
                mask_path=mask_path,
            )
        )
    return records


def load_patient_volume(
    rec: PatientRecord,
    spatial_size=C.SPATIAL_SIZE,
    zero_slices: str = "fill",
) -> np.ndarray:
    """Decode + mask + crop/fill + resize one patient to ``spatial_size``."""
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


def build_image_cohort(
    directories,
    patient_key_csv: str,
    spatial_size=C.SPATIAL_SIZE,
    zero_slices: str = "fill",
    image_format: str = "nifti",
) -> ImageCohort:
    """The (N, *spatial, C) cohort array: each directory (one per modality,
    e.g. T1 and T2) is resized on its own and the modalities are stacked
    on the channel axis, over the patients all modalities have."""
    if isinstance(directories, (str, os.PathLike)):
        directories = [directories]
    for d in directories:
        if image_format != "nifti" or is_remote(str(d)):
            raise ConfigurationError(
                f"{image_format} images at {d}: only local NIfTI cohorts are "
                "ported to mmnn_sts_torch (DICOM and s3:// are ROADMAP.md "
                "Queue 1 items)"
            )
    manifests = [build_manifest(d, patient_key_csv) for d in directories]

    common = set.intersection(*[{r.anon_id for r in m} for m in manifests])
    by_anon = [{r.anon_id: r for r in m} for m in manifests]
    anon_ids = sorted(common)

    per_modality = [
        np.stack([load_patient_volume(by_anon[m][anon], spatial_size,
                                      zero_slices) for anon in anon_ids])
        for m in range(len(manifests))
    ]
    return ImageCohort(
        uids=np.asarray([by_anon[0][a].uid for a in anon_ids], dtype=np.int64),
        volumes=np.stack(per_modality, axis=-1).astype(np.float32),
    )
