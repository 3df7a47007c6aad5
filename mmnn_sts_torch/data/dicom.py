"""Minimal DICOM series reader (pure python, no GDCM/SimpleITK).

Covers the role SimpleITK's C++ GDCM stack plays in the reference
(reference data/utils.py:16-37 loadImage/loadMask and
s3utils.py:244-265 readSitk): read a directory of single-frame .dcm slice
files, sort them into a volume, and apply rescale slope/intercept.

Supported transfer syntaxes: Implicit/Explicit VR Little Endian
(1.2.840.10008.1.2/.1), Deflated Explicit VR (.1.99), and the retired
Explicit VR Big Endian (1.2.840.10008.1.2.2) with uncompressed 8/16-bit
pixel data — the common export formats for the MRI/DicomRT data the
reference handles — plus the compressed syntaxes JPEG Lossless process 14
(data/jpeg_lossless.py), RLE (data/dicom_rle.py), JPEG-LS lossless /
near-lossless (data/jpeg_ls.py), JPEG 2000 reversible AND irreversible
(data/jpeg2000.py), and lossy sequential-DCT JPEG baseline/extended
(data/jpeg_baseline.py). Every syntax GDCM decoded for the reference's
cohorts decodes natively here; lossy decodes (.50/.51/.91-irreversible)
match the GDCM-ecosystem result within the codec's documented tolerance
and training proceeds on the lossy samples, as it did for the reference.

Slice ordering: by ImagePositionPatient projected on the slice normal when
available, else InstanceNumber — matching GDCM's series sorting behavior.

The port's own copy of the JAX package's data/dicom.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"
# Deflated Explicit VR LE (PS3.5 A.5): the dataset after the meta group is
# one raw-deflate stream. Explicit VR Big Endian is retired but persists in
# PACS archives; GDCM read both for the reference.
DEFLATED_LE = "1.2.840.10008.1.2.1.99"
EXPLICIT_BE = "1.2.840.10008.1.2.2"
# JPEG Lossless (T.81 process 14): .57 = any selection value, .70 = the
# first-order-prediction (SV1) profile — the dominant compressed MRI export.
# Decoded by data/jpeg_lossless.py (python) or the native fast path.
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
# RLE Lossless (PS3.5 Annex G) — decoded by data/dicom_rle.py.
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
# JPEG-LS (ITU-T T.87): .80 = lossless, .81 = near-lossless — the common
# compressed CT/CR export. Decoded by data/jpeg_ls.py.
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
# JPEG 2000 (ITU-T T.800): .90 = reversible-only (lossless), .91 = may be
# lossy. Decoded by data/jpeg2000.py — reversible streams exactly,
# irreversible (9/7, scalar-quantized) ones within float rounding of the
# OpenJPEG/GDCM result; like .50/.51, training proceeds on lossy samples.
J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"
J2K = "1.2.840.10008.1.2.4.91"
# Lossy sequential-DCT JPEG (T.81): .50 = baseline 8-bit, .51 = extended
# 12-bit. Decoded by data/jpeg_baseline.py — like the reference (via GDCM/
# libjpeg), training proceeds on the lossy samples.
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
_COMPRESSED_SYNTAXES = {
    JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1, RLE_LOSSLESS,
    JPEG_LS_LOSSLESS, JPEG_LS_NEAR, J2K_LOSSLESS, J2K,
    JPEG_BASELINE, JPEG_EXTENDED,
}

# VRs with 4-byte length (explicit VR encoding)
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"UC", b"UR", b"OD", b"OL"}


@dataclass
class DicomSlice:
    rows: int = 0
    cols: int = 0
    bits_allocated: int = 16
    pixel_representation: int = 0
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    fragments: list | None = None  # encapsulated (compressed) pixel fragments
    instance_number: int = 0
    number_of_frames: int = 1  # >1: multi-frame file (e.g. DicomRT masks)
    position: tuple | None = None
    orientation: tuple | None = None
    pixel_spacing: tuple | None = None  # (0028,0030) = (row, col) mm
    spacing_between_slices: float | None = None  # (0018,0088)
    grid_frame_offsets: tuple | None = None  # (3004,000C), multi-frame z
    pixel_data: bytes = b""
    transfer_syntax: str = EXPLICIT_LE
    extra: dict = field(default_factory=dict)


@dataclass
class SeriesGeometry:
    """Physical-space grid of a decoded series (LPS patient coordinates).

    Fills the role of sitk.Image's origin/spacing/direction metadata
    (reference data/s3utils.py:244-265 exposes it via GDCM): voxel
    (slice=k, row=i, col=j) sits at
        origin + row_dir * j * pixel_spacing[1]
               + col_dir * i * pixel_spacing[0]
               + normal  * z_offsets[k].
    row_dir/col_dir are ImageOrientationPatient's row/column cosines
    (row_dir = direction of increasing column index).
    """

    origin: np.ndarray  # (3,) position of voxel (0, 0, 0)
    row_dir: np.ndarray  # (3,)
    col_dir: np.ndarray  # (3,)
    pixel_spacing: tuple  # (row_sp, col_sp) mm
    z_offsets: np.ndarray  # (n_slices,) mm along `normal` from origin

    @property
    def normal(self) -> np.ndarray:
        return np.cross(self.row_dir, self.col_dir)

    def same_grid(self, other: "SeriesGeometry", shape, other_shape,
                  tol: float = 1e-3) -> bool:
        return (
            tuple(shape) == tuple(other_shape)
            and np.allclose(self.origin, other.origin, atol=tol)
            and np.allclose(self.row_dir, other.row_dir, atol=tol)
            and np.allclose(self.col_dir, other.col_dir, atol=tol)
            and np.allclose(self.pixel_spacing, other.pixel_spacing, atol=tol)
            and self.z_offsets.shape == other.z_offsets.shape
            and np.allclose(self.z_offsets, other.z_offsets, atol=tol)
        )


def _parse_elements(buf: bytes, offset: int, explicit: bool,
                    stop_at_pixels=True, endian: str = "<"):
    """Yield (group, element, value_bytes) until exhaustion."""
    n = len(buf)
    while offset + 8 <= n:
        group, element = struct.unpack_from(endian + "HH", buf, offset)
        offset += 4
        if explicit or group == 0x0002:
            vr = buf[offset : offset + 2]
            if vr in _LONG_VRS:
                (length,) = struct.unpack_from(endian + "I", buf, offset + 4)
                offset += 8
            elif vr.isalpha() and vr.isupper():
                (length,) = struct.unpack_from(endian + "H", buf, offset + 2)
                offset += 4
            else:  # implicit element inside an explicit stream (rare)
                (length,) = struct.unpack_from(endian + "I", buf, offset)
                offset += 4
        else:
            (length,) = struct.unpack_from(endian + "I", buf, offset)
            offset += 4
        if length == 0xFFFFFFFF:
            if (group, element) == (0x7FE0, 0x0010):
                # encapsulated pixel data: item sequence -> fragment list
                frags, offset = _parse_encapsulated(buf, offset)
                yield group, element, frags
                return
            raise ValueError(
                "Undefined-length element (sequence data?) is only "
                "supported for encapsulated pixel data"
            )
        value = buf[offset : offset + length]
        offset += length
        yield group, element, value
        if stop_at_pixels and (group, element) == (0x7FE0, 0x0010):
            return


def _parse_encapsulated(buf: bytes, offset: int):
    """Parse an encapsulated pixel-data item sequence (PS3.5 A.4).

    Returns (fragments, new_offset). The first item is the Basic Offset
    Table (kept: empty or one uint32 per frame); subsequent items are the
    compressed fragments; the sequence ends at the (FFFE,E0DD) delimiter.
    """
    items = []
    n = len(buf)
    while offset + 8 <= n:
        group, element = struct.unpack_from("<HH", buf, offset)
        (length,) = struct.unpack_from("<I", buf, offset + 4)
        offset += 8
        if (group, element) == (0xFFFE, 0xE0DD):
            break
        if (group, element) != (0xFFFE, 0xE000):
            raise ValueError(
                f"malformed encapsulated pixel data: tag {group:04x},{element:04x}"
            )
        items.append(buf[offset : offset + length])
        offset += length
    if not items:
        raise ValueError("encapsulated pixel data with no items")
    bot, frags = items[0], items[1:]
    if not frags:
        raise ValueError("encapsulated pixel data with no fragments")
    return {"bot": bot, "fragments": frags}, offset


def _read_meta(buf: bytes):
    """Parse the file-meta group; returns (transfer_syntax, dataset_offset)."""
    if buf[128:132] != b"DICM":
        # Some files omit the preamble; try from byte 0 as implicit LE.
        return IMPLICIT_LE, 0
    transfer_syntax = EXPLICIT_LE
    pos = 132
    n = len(buf)
    while pos + 8 <= n:
        group, element = struct.unpack_from("<HH", buf, pos)
        if group != 0x0002:
            break
        vr = buf[pos + 4 : pos + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", buf, pos + 8)
            value = buf[pos + 12 : pos + 12 + length]
            pos += 12 + length
        else:
            (length,) = struct.unpack_from("<H", buf, pos + 6)
            value = buf[pos + 8 : pos + 8 + length]
            pos += 8 + length
        if element == 0x0010:
            transfer_syntax = value.decode("ascii", "ignore").strip("\x00 ")
    return transfer_syntax, pos


def read_dicom_file(path: str) -> DicomSlice:
    with open(path, "rb") as f:
        buf = f.read()
    syntax, offset = _read_meta(buf)
    if syntax not in (IMPLICIT_LE, EXPLICIT_LE, DEFLATED_LE, EXPLICIT_BE) \
            and syntax not in _COMPRESSED_SYNTAXES:
        raise ValueError(
            f"{path}: unsupported transfer syntax {syntax} (supported: "
            "uncompressed LE/BE/deflated, JPEG Lossless process 14, "
            "JPEG-LS, JPEG 2000, RLE Lossless, and lossy JPEG "
            "baseline/extended; convert other exports to one of those "
            "or NIfTI)"
        )
    explicit = syntax != IMPLICIT_LE  # all encapsulated syntaxes are explicit
    if syntax == DEFLATED_LE:
        import zlib

        # the dataset after the meta group is one raw-deflate stream
        buf = zlib.decompress(buf[offset:], -15)
        offset = 0
    endian = ">" if syntax == EXPLICIT_BE else "<"
    us = endian + "H"

    s = DicomSlice(transfer_syntax=syntax)
    for group, element, value in _parse_elements(buf, offset, explicit,
                                                 endian=endian):
        tag = (group, element)
        if tag == (0x0028, 0x0010):
            s.rows = struct.unpack(us, value[:2])[0]
        elif tag == (0x0028, 0x0011):
            s.cols = struct.unpack(us, value[:2])[0]
        elif tag == (0x0028, 0x0100):
            s.bits_allocated = struct.unpack(us, value[:2])[0]
        elif tag == (0x0028, 0x0103):
            s.pixel_representation = struct.unpack(us, value[:2])[0]
        elif tag == (0x0028, 0x1052):
            s.rescale_intercept = float(value.decode("ascii", "ignore").strip() or 0)
        elif tag == (0x0028, 0x1053):
            s.rescale_slope = float(value.decode("ascii", "ignore").strip() or 1)
        elif tag == (0x0020, 0x0013):
            try:
                s.instance_number = int(value.decode("ascii", "ignore").strip())
            except ValueError:
                pass
        elif tag == (0x0028, 0x0008):
            try:
                s.number_of_frames = int(value.decode("ascii", "ignore").strip())
            except ValueError:
                pass
        elif tag == (0x0020, 0x0032):
            parts = value.decode("ascii", "ignore").strip().split("\\")
            if len(parts) == 3:
                s.position = tuple(float(p) for p in parts)
        elif tag == (0x0020, 0x0037):
            parts = value.decode("ascii", "ignore").strip().split("\\")
            if len(parts) == 6:
                s.orientation = tuple(float(p) for p in parts)
        elif tag == (0x0028, 0x0030):
            parts = value.decode("ascii", "ignore").strip().split("\\")
            if len(parts) == 2:
                s.pixel_spacing = tuple(float(p) for p in parts)
        elif tag == (0x0018, 0x0088):
            try:
                s.spacing_between_slices = float(
                    value.decode("ascii", "ignore").strip()
                )
            except ValueError:
                pass
        elif tag == (0x3004, 0x000C):
            parts = value.decode("ascii", "ignore").strip().split("\\")
            try:
                s.grid_frame_offsets = tuple(float(p) for p in parts)
            except ValueError:
                pass
        elif tag == (0x7FE0, 0x0010):
            if isinstance(value, dict):  # encapsulated (compressed)
                s.fragments = value["fragments"]
                s.extra["bot"] = value["bot"]
            else:
                s.pixel_data = value
    if (not s.pixel_data and not s.fragments) or not s.rows:
        raise ValueError(f"{path}: no pixel data found")
    return s


def _decode_fragments(s: DicomSlice) -> np.ndarray:
    """Decode encapsulated compressed frames -> (frames, rows, cols).

    Dispatches on the transfer syntax: JPEG Lossless process 14
    (data/jpeg_lossless.py + native fast path), RLE Lossless
    (data/dicom_rle.py, which PS3.5 G restricts to one fragment per
    frame), JPEG-LS (data/jpeg_ls.py + native fast path), JPEG 2000
    (data/jpeg2000.py + native fast path), or lossy sequential-DCT JPEG
    (data/jpeg_baseline.py). Frame <-> fragment mapping (PS3.5 A.4): single-frame objects
    may split one frame across many fragments (concatenate); multi-frame
    objects must start each frame on a fragment boundary — with one
    fragment per frame when no Basic Offset Table is present, else the
    BOT gives the byte offset of each frame's first fragment.
    """
    frames = max(1, s.number_of_frames)
    frags = s.fragments
    if frames == 1:
        streams = [b"".join(frags)]
    elif len(frags) == frames:
        streams = [bytes(f) for f in frags]
    else:
        bot = np.frombuffer(s.extra.get("bot", b""), dtype="<u4")
        if len(bot) != frames:
            raise ValueError(
                f"cannot map {len(frags)} fragments onto {frames} frames "
                "(no usable Basic Offset Table)"
            )
        # BOT offsets are to the start of each frame's first item header
        offsets = [0]
        for f in frags[:-1]:
            offsets.append(offsets[-1] + 8 + len(f))
        start_of = {off: i for i, off in enumerate(offsets)}
        bad = [int(o) for o in bot if int(o) not in start_of]
        if bad:
            # corrupt BOT entries must fail with the same clean ValueError
            # contract as every other malformed-stream path (codec_util.py),
            # not an unhandled KeyError mid-cohort-build
            raise ValueError(
                f"Basic Offset Table offset {bad[0]} does not land on a "
                "fragment boundary (corrupt BOT)"
            )
        streams = []
        bounds = [start_of[int(o)] for o in bot] + [len(frags)]
        for a, b in zip(bounds, bounds[1:]):
            streams.append(b"".join(frags[a:b]))

    if s.transfer_syntax == RLE_LOSSLESS:
        from .dicom_rle import decode_rle_frame

        def decode_one(st: bytes) -> np.ndarray:
            return decode_rle_frame(bytes(st), s.rows, s.cols,
                                    s.bits_allocated)
    elif s.transfer_syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR):
        from .jpeg_ls import decode_jpeg_ls
        from .native import jpeg_ls_decode_native

        def decode_one(st: bytes) -> np.ndarray:
            fast = jpeg_ls_decode_native(bytes(st), s.rows, s.cols)
            return fast if fast is not None else decode_jpeg_ls(bytes(st))
    elif s.transfer_syntax in (J2K_LOSSLESS, J2K):
        from .jpeg2000 import decode_j2k
        from .native import j2k_decode_native

        def decode_one(st: bytes) -> np.ndarray:
            vals = j2k_decode_native(bytes(st), s.rows, s.cols)
            if vals is None:
                vals = decode_j2k(bytes(st))
                if vals.shape != (s.rows, s.cols):
                    raise ValueError(
                        f"JPEG 2000 frame is {vals.shape[0]}x"
                        f"{vals.shape[1]}, DICOM says {s.rows}x{s.cols}"
                    )
            dt = np.uint8 if s.bits_allocated == 8 else np.uint16
            return (vals & ((1 << s.bits_allocated) - 1)).astype(dt)
    elif s.transfer_syntax in (JPEG_BASELINE, JPEG_EXTENDED):
        from .jpeg_baseline import decode_jpeg_baseline

        def decode_one(st: bytes) -> np.ndarray:
            vals = decode_jpeg_baseline(bytes(st))
            if vals.shape != (s.rows, s.cols):
                raise ValueError(
                    f"JPEG frame is {vals.shape[0]}x{vals.shape[1]}, "
                    f"DICOM says {s.rows}x{s.cols}"
                )
            dt = np.uint8 if s.bits_allocated == 8 else np.uint16
            return (vals & ((1 << s.bits_allocated) - 1)).astype(dt)
    else:
        from .jpeg_lossless import decode_jpeg_lossless
        from .native import jpeg_lossless_decode_native

        def decode_one(st: bytes) -> np.ndarray:
            fast = jpeg_lossless_decode_native(bytes(st), s.rows, s.cols)
            return fast if fast is not None else decode_jpeg_lossless(st)

    decoded = np.stack([decode_one(st) for st in streams])
    if s.pixel_representation:
        # Reinterpret the STORED words (BitsAllocated wide) as two's
        # complement. Key by BitsAllocated, not the decoder's array dtype:
        # the JPEG-LS/JPEG-Lossless decoders return uint16 even for 8-bit
        # streams, and viewing those as int16 would fail to sign-extend the
        # 8-bit words (0xFF must decode to -1, not +255).
        if s.bits_allocated == 8:
            decoded = decoded.astype(np.uint8).view(np.int8)
        else:
            decoded = decoded.astype(np.uint16).view(np.int16)
    return decoded.astype(np.float32)


def _slice_array(s: DicomSlice) -> np.ndarray:
    """Pixel data -> (rows, cols) or, for multi-frame files (e.g. DicomRT
    segmentation masks, which GDCM surfaced as 4D-with-singleton to the
    reference, data/s3utils.py:261-265), (frames, rows, cols).
    """
    frames = max(1, s.number_of_frames)
    if s.fragments is not None:
        arr = _decode_fragments(s)
        if frames == 1:
            arr = arr[0]
    else:
        if s.bits_allocated == 16:
            be = s.transfer_syntax == EXPLICIT_BE
            dtype = np.dtype((">" if be else "<")
                             + ("i2" if s.pixel_representation else "u2"))
        elif s.bits_allocated == 8:
            dtype = np.int8 if s.pixel_representation else np.uint8
        else:
            raise ValueError(f"unsupported BitsAllocated {s.bits_allocated}")
        arr = np.frombuffer(
            s.pixel_data, dtype=dtype, count=frames * s.rows * s.cols
        )
        if frames > 1:
            arr = arr.reshape(frames, s.rows, s.cols).astype(np.float32)
        else:
            arr = arr.reshape(s.rows, s.cols).astype(np.float32)
    if s.rescale_slope != 1.0 or s.rescale_intercept != 0.0:
        arr = arr * s.rescale_slope + s.rescale_intercept
    return arr


def _multiframe_geometry(s: DicomSlice) -> SeriesGeometry | None:
    """Geometry of a multi-frame file (e.g. a DicomRT mask): through-plane
    offsets come from GridFrameOffsetVector (3004,000C) — which may be
    DESCENDING, i.e. the stored frame order is z-reversed relative to a
    position-sorted slice series — else SpacingBetweenSlices."""
    if s.position is None or s.orientation is None or s.pixel_spacing is None:
        return None
    frames = max(1, s.number_of_frames)
    if s.grid_frame_offsets is not None and len(s.grid_frame_offsets) == frames:
        z = np.asarray(s.grid_frame_offsets, dtype=np.float64)
    elif frames == 1:
        z = np.zeros((1,))
    elif s.spacing_between_slices is not None:
        z = np.arange(frames, dtype=np.float64) * s.spacing_between_slices
    else:
        return None
    return SeriesGeometry(
        origin=np.asarray(s.position, dtype=np.float64),
        row_dir=np.asarray(s.orientation[:3], dtype=np.float64),
        col_dir=np.asarray(s.orientation[3:], dtype=np.float64),
        pixel_spacing=tuple(s.pixel_spacing),
        z_offsets=z,
    )


def _series_geometry(slices: list[DicomSlice]) -> SeriesGeometry | None:
    """Geometry of a position-sorted single-frame series."""
    first = slices[0]
    if any(
        s.position is None or s.orientation is None or s.pixel_spacing is None
        for s in slices
    ):
        return None
    normal = np.cross(
        np.asarray(first.orientation[:3]), np.asarray(first.orientation[3:])
    )
    origin = np.asarray(first.position, dtype=np.float64)
    z = np.asarray(
        [np.dot(normal, np.asarray(s.position) - origin) for s in slices]
    )
    return SeriesGeometry(
        origin=origin,
        row_dir=np.asarray(first.orientation[:3], dtype=np.float64),
        col_dir=np.asarray(first.orientation[3:], dtype=np.float64),
        pixel_spacing=tuple(first.pixel_spacing),
        z_offsets=z,
    )


def load_dicom_series(path: str, with_geometry: bool = False):
    """Read a DICOM series into a (slices, rows, cols) float32 volume.

    `path` is a directory of single-frame slice files (sorted into a volume),
    a directory containing one multi-frame file, or a single .dcm file
    (multi-frame masks load as (frames, rows, cols); single-frame as
    (1, rows, cols)). Covers readSitk's role
    (reference data/s3utils.py:244-265) including the 4D-singleton
    squeeze for DicomRT masks.

    with_geometry=True returns (volume, SeriesGeometry | None); geometry is
    None when position/orientation/spacing tags are incomplete.
    """
    if os.path.isfile(path):
        files = [path]
    else:
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if not f.startswith(".") and f.lower().endswith((".dcm", ".ima"))
        )
        if not files:
            files = sorted(
                os.path.join(path, f)
                for f in os.listdir(path)
                if not f.startswith(".") and os.path.isfile(os.path.join(path, f))
            )
    slices = [read_dicom_file(f) for f in files]
    if not slices:
        raise ValueError(f"no DICOM slices found in {path}")

    if len(slices) == 1 and slices[0].number_of_frames > 1:
        vol = _slice_array(slices[0])  # multi-frame file IS the volume
        if with_geometry:
            return vol, _multiframe_geometry(slices[0])
        return vol

    if all(s.position is not None and s.orientation is not None for s in slices):
        normal = np.cross(
            np.asarray(slices[0].orientation[:3]),
            np.asarray(slices[0].orientation[3:]),
        )
        slices.sort(key=lambda s: float(np.dot(normal, np.asarray(s.position))))
        geom = _series_geometry(slices)
    else:
        slices.sort(key=lambda s: s.instance_number)
        geom = None

    arrs = [_slice_array(s) for s in slices]
    vol = np.concatenate([a[None] if a.ndim == 2 else a for a in arrs], axis=0)
    if with_geometry:
        return vol, geom
    return vol


def resample_to_grid(
    mask: np.ndarray,
    mask_geom: SeriesGeometry,
    image_shape,
    image_geom: SeriesGeometry,
) -> np.ndarray:
    """Resample `mask` onto the image's physical voxel grid (trilinear).

    Replacement for the reference's `sitk.Resample(mask, image)`
    (reference data/ImageDatasets.py:146): maps each image voxel
    center through patient space into fractional mask indices and linearly
    interpolates (outside → 0, sitk's default). Requires the two series to
    share in-plane axes (same row/col direction cosines up to tolerance);
    oblique cross-orientation pairs raise. Through-plane order is aligned
    via physical z offsets, so a z-reversed multi-frame mask (descending
    GridFrameOffsetVector) lands correctly.
    """
    if not (
        np.allclose(mask_geom.row_dir, image_geom.row_dir, atol=1e-3)
        and np.allclose(mask_geom.col_dir, image_geom.col_dir, atol=1e-3)
    ):
        raise ValueError(
            "DICOM mask and image have different in-plane orientations; "
            "oblique cross-orientation resampling is not supported — "
            "resample the mask onto the image grid upstream"
        )
    if mask_geom.same_grid(image_geom, mask.shape, image_shape):
        return mask

    from scipy.ndimage import map_coordinates

    delta = image_geom.origin - mask_geom.origin
    # fractional mask indices of the image voxel centers, per axis
    # (axes are shared, so the mapping is separable)
    zi = np.dot(image_geom.normal, delta) + image_geom.z_offsets  # physical z
    mz = mask_geom.z_offsets
    if mz.size > 1 and mz[0] > mz[-1]:  # descending storage order
        k = np.interp(zi, mz[::-1], np.arange(mz.size)[::-1].astype(np.float64))
    elif mz.size > 1:
        k = np.interp(zi, mz, np.arange(mz.size, dtype=np.float64))
    else:
        k = np.zeros_like(zi)
    # np.interp clamps outside the range; mark out-of-bounds to land outside
    # so map_coordinates zeroes them (sitk returns defaultPixelValue there)
    lo, hi = min(mz[0], mz[-1]), max(mz[0], mz[-1])
    k = np.where((zi < lo - 1e-6) | (zi > hi + 1e-6), -2.0, k)

    i = (np.dot(image_geom.col_dir, delta)
         + np.arange(image_shape[1]) * image_geom.pixel_spacing[0]) \
        / mask_geom.pixel_spacing[0]
    j = (np.dot(image_geom.row_dir, delta)
         + np.arange(image_shape[2]) * image_geom.pixel_spacing[1]) \
        / mask_geom.pixel_spacing[1]

    kk, ii, jj = np.meshgrid(k, i, j, indexing="ij")
    return map_coordinates(
        mask.astype(np.float32), [kk, ii, jj], order=1,
        mode="constant", cval=0.0,
    ).astype(np.float32)
