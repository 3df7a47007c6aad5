"""ctypes bindings of the host C++ library of the cohort build,
``native/mmnn_native.cpp`` (counterpart of the JAX package's
data/native.py:27-286): NIfTI decode (zlib inflate, dtype and endian
conversion, scl scaling), the fused mask / crop-or-fill / trilinear resize
of one patient, a GIL-free ``std::thread`` pool over a cohort, and the
JPEG-LS, JPEG-Lossless and JPEG 2000 frame decoders.

The library is compiled from the checkout's source at first use
(``kernels/build.build_host``, into ``kernels/_build/``). There is no
silent numpy path when it is missing: a failed build raises. Two
per-input fallbacks keep the JAX package's semantics:

* a NIfTI variant the pool rejects (a nonzero per-patient status) is
  decoded by the numpy path (``data/images._load_modality_volumes``);
* a frame whose C++ decoder answers "needs the Python path" (a nonzero
  status; for JPEG Lossless only a multi-component stream) is decoded by
  the Python codec (``data/dicom._decode_fragments``).

``counts`` tallies what ran, per patient and per frame: ``native_patients``
and ``patient_fallbacks`` (patients the C++ path, pool or single,
preprocessed / rejected),
``<codec>_frames`` (frames each C++ decoder decoded) and
``frame_fallbacks`` (frames handed to the Python decoder).
``reset_counts()`` sets them to 0.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..kernels import build

_ZERO_MODES = {"crop": 0, "fill": 1, "none": 2}
_COUNT_NAMES = ("native_patients", "patient_fallbacks", "jpeg_ls_frames",
                "jpeg_lossless_frames", "j2k_frames", "frame_fallbacks")
counts = dict.fromkeys(_COUNT_NAMES, 0)
_count_lock = threading.Lock()
_LIB = None
_lib_lock = threading.Lock()


def reset_counts():
    with _count_lock:
        counts.update(dict.fromkeys(_COUNT_NAMES, 0))


def _count(name: str, n: int = 1):
    with _count_lock:
        counts[name] += int(n)


def _signatures(lib):
    i64, c_int = ctypes.c_int64, ctypes.c_int
    p_int = ctypes.POINTER(c_int)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    for fn, args, res in (
        ("mmnn_nifti_dims", [ctypes.c_char_p, ctypes.POINTER(i64), p_int],
         c_int),
        ("mmnn_nifti_read", [ctypes.c_char_p, p_f32, i64], c_int),
        ("mmnn_preprocess_patient", [ctypes.c_char_p, ctypes.c_char_p, c_int,
                                     i64, i64, i64, p_f32], c_int),
        ("mmnn_preprocess_cohort", [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.POINTER(ctypes.c_char_p), i64,
                                    c_int, i64, i64, i64, c_int, p_f32,
                                    p_int], None),
        ("mmnn_jpeg_lossless_decode", [ctypes.c_char_p, i64,
                                       ctypes.POINTER(ctypes.c_uint16), i64,
                                       p_int, p_int], c_int),
        ("mmnn_jpeg_ls_decode", [ctypes.c_char_p, i64,
                                 ctypes.POINTER(ctypes.c_uint16), i64, p_int,
                                 p_int], c_int),
        ("mmnn_j2k_decode", [ctypes.c_char_p, i64,
                             ctypes.POINTER(ctypes.c_int32), i64, p_int,
                             p_int], c_int),
    ):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res


def _load():
    """The library, built on the first call; raises if it cannot be."""
    global _LIB
    with _lib_lock:
        if _LIB is None:
            lib = build.load_host("mmnn_native")
            _signatures(lib)
            _LIB = lib
        return _LIB


def load_nifti_native(path: str) -> np.ndarray:
    """A NIfTI volume decoded in C++ as float32 (get_fdata semantics)."""
    lib = _load()
    dims = (ctypes.c_int64 * 7)()
    ndim = ctypes.c_int(0)
    if lib.mmnn_nifti_dims(path.encode(), dims, ctypes.byref(ndim)) != 0:
        raise IOError(f"native NIfTI dim query failed for {path}")
    shape = tuple(int(dims[i]) for i in range(ndim.value))
    n = int(np.prod(shape))
    out = np.empty(n, dtype=np.float32)
    rc = lib.mmnn_nifti_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if rc != 0:
        raise IOError(f"native NIfTI decode failed ({rc}) for {path}")
    return out.reshape(shape, order="F")


def preprocess_patient_native(image_path: str, mask_path: str,
                              zero_slices: str, spatial_size) -> np.ndarray:
    """One patient decoded, masked, cropped or filled and resized in C++;
    raises IOError (counted as a patient fallback) where the library
    rejects the input."""
    lib = _load()
    m0, m1, m2 = spatial_size
    out = np.empty(m0 * m1 * m2, dtype=np.float32)
    rc = lib.mmnn_preprocess_patient(
        image_path.encode(), mask_path.encode(), _ZERO_MODES[zero_slices],
        m0, m1, m2, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        _count("patient_fallbacks")
        raise IOError(
            f"native preprocess failed ({rc}) for {image_path} / {mask_path}")
    _count("native_patients")
    return out.reshape((m0, m1, m2), order="F")


def _decode_frame(fn: str, name: str, blob: bytes, rows: int, cols: int,
                  dtype, what: str):
    """One frame through the C++ decoder ``fn``: (rows, cols) of ``dtype``,
    or None (counted as a frame fallback) where it answers "needs the
    Python path"."""
    out = np.empty(rows * cols, dtype=dtype)
    r, c = ctypes.c_int(0), ctypes.c_int(0)
    rc = getattr(_load(), fn)(
        blob, len(blob),
        out.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(dtype))),
        out.size, ctypes.byref(r), ctypes.byref(c))
    if rc != 0:
        return rc
    if (r.value, c.value) != (rows, cols):
        raise ValueError(
            f"{what} frame is {r.value}x{c.value}, DICOM says {rows}x{cols}")
    _count(name)
    return out.reshape(rows, cols)


def jpeg_lossless_decode_native(blob: bytes, rows: int,
                                cols: int) -> np.ndarray | None:
    """One SOF3 frame decoded in C++; None for a multi-component stream
    (the Python decoder takes it). rows/cols are the DICOM dimensions; the
    stream's own header is authoritative and checked against them."""
    out = _decode_frame("mmnn_jpeg_lossless_decode", "jpeg_lossless_frames",
                        blob, rows, cols, np.uint16, "JPEG")
    if isinstance(out, np.ndarray):
        return out
    if out == 12:  # multi-component: the Python decoder takes it
        _count("frame_fallbacks")
        return None
    raise ValueError(f"native JPEG-Lossless decode failed (rc={out})")


def jpeg_ls_decode_native(blob: bytes, rows: int,
                          cols: int) -> np.ndarray | None:
    """One JPEG-LS (T.87) frame decoded in C++; None where the stream needs
    the Python decoder (data/jpeg_ls.py), which also owns the error
    messages for malformed streams."""
    out = _decode_frame("mmnn_jpeg_ls_decode", "jpeg_ls_frames", blob, rows,
                        cols, np.uint16, "JPEG-LS")
    if isinstance(out, np.ndarray):
        return out
    _count("frame_fallbacks")
    return None


def j2k_decode_native(blob: bytes, rows: int, cols: int) -> np.ndarray | None:
    """One JPEG 2000 frame decoded in C++ as int32 samples (negative iff the
    stream is signed); None where the stream needs the Python decoder
    (data/jpeg2000.py), which also owns the error messages."""
    out = _decode_frame("mmnn_j2k_decode", "j2k_frames", blob, rows, cols,
                        np.int32, "JPEG 2000")
    if isinstance(out, np.ndarray):
        return out
    _count("frame_fallbacks")
    return None


def preprocess_cohort_native(image_paths, mask_paths, zero_slices: str,
                             spatial_size, num_threads: int = 0):
    """N patients decoded and preprocessed by the C++ thread pool:
    ((N, m0, m1, m2) float32, (N,) int32 per-patient status, 0 = ok). The
    caller decodes a rejected patient through the numpy path; each is
    counted in ``patient_fallbacks``."""
    lib = _load()
    n = len(image_paths)
    m0, m1, m2 = spatial_size
    out = np.empty((n, m0 * m1 * m2), dtype=np.float32)
    errors = np.zeros(n, dtype=np.int32)
    img_arr = (ctypes.c_char_p * n)(*[p.encode() for p in image_paths])
    msk_arr = (ctypes.c_char_p * n)(*[p.encode() for p in mask_paths])
    lib.mmnn_preprocess_cohort(
        img_arr, msk_arr, n, _ZERO_MODES[zero_slices], m0, m1, m2,
        num_threads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        errors.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    rejected = int(np.count_nonzero(errors))
    _count("native_patients", n - rejected)
    _count("patient_fallbacks", rejected)
    # each row is a Fortran-ordered (m0, m1, m2) volume
    vols = np.ascontiguousarray(out.reshape(n, m2, m1, m0).transpose(0, 3, 2, 1))
    return vols, errors
