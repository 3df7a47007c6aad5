"""Minimal NIfTI-1 reader/writer in pure numpy and gzip, and the per-patient
attention-map export (a copy of the JAX package's data/nifti.py:44-164; no
nibabel).

* single-file .nii / .nii.gz, NIfTI-1 (348-byte header, magic 'n+1');
* both endiannesses; datatypes uint8/int8/int16/uint16/int32/uint32/
  float32/float64;
* scl_slope/scl_inter scaling (get_fdata semantics: float64 output);
* Fortran-ordered voxel data, shape = dim[1:1+ndim];
* the writer emits float32 single-file NIfTI-1 with an identity affine in
  the sform.

The JAX package's C++ decode path is not ported (ROADMAP.md).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def load_nifti(path: str, dtype=np.float64) -> np.ndarray:
    """Read a NIfTI-1 volume, returning scaled voxel data (get_fdata
    semantics)."""
    blob = _read_bytes(path)
    if len(blob) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")

    (sizeof_hdr,) = struct.unpack_from("<i", blob, 0)
    bo = "<"
    if sizeof_hdr != HEADER_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", blob, 0)
        if sizeof_hdr != HEADER_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        bo = ">"

    magic = blob[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(f"{bo}8h", blob, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack_from(f"{bo}h", blob, 70)
    (vox_offset,) = struct.unpack_from(f"{bo}f", blob, 108)
    (scl_slope,) = struct.unpack_from(f"{bo}f", blob, 112)
    (scl_inter,) = struct.unpack_from(f"{bo}f", blob, 116)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    offset = int(vox_offset) if vox_offset else HEADER_SIZE + 4
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(blob, dtype=np_dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")

    out = data.astype(dtype)
    if scl_slope not in (0.0, 1.0) and np.isfinite(scl_slope):
        out = out * scl_slope + scl_inter
    elif scl_inter not in (0.0,) and np.isfinite(scl_inter) and scl_slope == 1.0:
        out = out + scl_inter
    return out


def save_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None):
    """Write a float32 single-file NIfTI-1 volume (.nii or .nii.gz)."""
    data = np.asarray(data, dtype=np.float32)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, dtype=np.float32)
    ndim = data.ndim
    if ndim > 7:
        raise ValueError("NIfTI supports at most 7 dimensions")

    header = bytearray(HEADER_SIZE)
    struct.pack_into("<i", header, 0, HEADER_SIZE)
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, _DTYPE_CODES[np.dtype(np.float32)])
    struct.pack_into("<h", header, 72, 32)  # bitpix
    pixdim = [1.0] * 8
    struct.pack_into("<8f", header, 76, *pixdim)
    struct.pack_into("<f", header, 108, float(HEADER_SIZE + 4))  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    struct.pack_into("<f", header, 116, 0.0)  # scl_inter
    struct.pack_into("<h", header, 252, 1)  # qform_code
    struct.pack_into("<h", header, 254, 1)  # sform_code
    # quaternion b,c,d = 0 and offsets from affine translation
    struct.pack_into("<6f", header, 256, 0.0, 0.0, 0.0,
                     float(affine[0, 3]), float(affine[1, 3]), float(affine[2, 3]))
    struct.pack_into("<4f", header, 280, *affine[0, :4])
    struct.pack_into("<4f", header, 296, *affine[1, :4])
    struct.pack_into("<4f", header, 312, *affine[2, :4])
    header[344:348] = b"n+1\x00"

    payload = (
        bytes(header) + b"\x00\x00\x00\x00" + np.asfortranarray(data).tobytes(order="F")
    )
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def save_attention_maps(out_dir: str, t1: np.ndarray, t2: np.ndarray,
                        att_map: np.ndarray, preds,
                        preds_filename: str = "preds.txt", extra_maps=None):
    """One patient's attention-map directory (nifti.py:138-164):
    t1image.nii.gz, t2image.nii.gz, att_map.nii.gz (class 0),
    att_map_cls{c}.nii.gz for each class c of ``extra_maps`` ({c: volume}),
    and the predictions as text (preds.txt for survival, probabilities.txt
    for classification), each value's ``str(float)`` written with no
    separator, as the JAX package writes them."""
    os.makedirs(out_dir, exist_ok=True)
    save_nifti(os.path.join(out_dir, "t1image.nii.gz"), t1)
    save_nifti(os.path.join(out_dir, "t2image.nii.gz"), t2)
    save_nifti(os.path.join(out_dir, "att_map.nii.gz"), att_map)
    for cls, vol in (extra_maps or {}).items():
        save_nifti(os.path.join(out_dir, f"att_map_cls{cls}.nii.gz"), vol)
    with open(os.path.join(out_dir, preds_filename), "w") as f:
        for p in np.asarray(preds).reshape(-1):
            f.write(str(float(p)))
