"""DICOM RLE Lossless (1.2.840.10008.1.2.5) codec — pure python.

Extends the compressed-transfer-syntax coverage beyond JPEG Lossless
(data/jpeg_lossless.py): the reference decodes RLE for free through
SimpleITK/GDCM (reference data/s3utils.py:244-265), and RLE is the
other lossless syntax a PACS commonly emits for MRI/CT and DicomRT
exports. Implemented from the public PS3.5 Annex G spec; no code is
derived from GDCM or the reference.

Format (PS3.5 G.3): each frame is one encapsulated fragment holding a
64-byte header (16 little-endian uint32: [0]=segment count, [1:]=byte
offsets of each segment from the frame start) followed by the segments.
A sample's bytes are split big-endian across segments ("composite pixel
code"): 16-bit data has 2 segments — segment 0 carries every sample's
MSB, segment 1 the LSB. Each segment is PackBits-encoded (G.3.1):
control byte n in [0, 127] copies the next n+1 literal bytes; n in
[129, 255] repeats the next byte 257-n times; n == 128 is a no-op.

The decoder is run-level python (one iteration per run, not per byte) —
fast enough that cohort decode stays dominated by the resample, so no
C++ fast path is needed (unlike the bit-serial JPEG Huffman decode).
The encoder exists for golden round-trip tests and fixture generation.

The port's own copy of the JAX package's data/dicom_rle.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

import struct

import numpy as np

from .codec_util import corrupt_stream_guard

_HEADER_LEN = 64


def _unpack_bits(data: bytes, start: int, end: int, expected: int) -> np.ndarray:
    """PackBits-decode data[start:end] into exactly `expected` bytes."""
    b = np.frombuffer(data, dtype=np.uint8)
    end = min(end, len(b))  # a truncated frame must raise, not overread
    out = np.empty(expected, dtype=np.uint8)
    pos = 0
    i = start
    while i < end and pos < expected:
        h = int(b[i])
        i += 1
        if h < 128:  # literal run of h+1 bytes
            cnt = h + 1
            if i + cnt > end or pos + cnt > expected:
                raise ValueError("RLE literal run overruns segment")
            out[pos : pos + cnt] = b[i : i + cnt]
            i += cnt
            pos += cnt
        elif h > 128:  # replicate next byte 257-h times
            cnt = 257 - h
            if i >= end or pos + cnt > expected:
                raise ValueError("RLE replicate run overruns segment")
            out[pos : pos + cnt] = b[i]
            i += 1
            pos += cnt
        # h == 128: no-op (PS3.5 G.3.1)
    if pos != expected:
        raise ValueError(
            f"RLE segment decoded {pos} bytes, expected {expected}"
        )
    return out


@corrupt_stream_guard
def decode_rle_frame(
    frame: bytes, rows: int, cols: int, bits_allocated: int
) -> np.ndarray:
    """Decode one RLE frame fragment -> (rows, cols) uint8/uint16 array.

    16-bit output is the big-endian composite of the MSB and LSB segments;
    signedness is the caller's reinterpretation (pixel_representation),
    matching the uncompressed and JPEG paths in data/dicom.py.
    """
    if len(frame) < _HEADER_LEN:
        raise ValueError("RLE frame shorter than its 64-byte header")
    header = struct.unpack_from("<16I", frame, 0)
    nseg = header[0]
    bytes_per_sample = bits_allocated // 8
    if bits_allocated not in (8, 16):
        raise ValueError(f"unsupported BitsAllocated {bits_allocated} for RLE")
    if nseg != bytes_per_sample:
        # Color (3/6 segments) never occurs for the MRI/RT data this
        # framework handles; raise rather than silently take one plane.
        raise ValueError(
            f"RLE frame has {nseg} segments; expected {bytes_per_sample} "
            f"for {bits_allocated}-bit grayscale"
        )
    n = rows * cols
    offsets = list(header[1 : 1 + nseg]) + [len(frame)]
    planes = [
        _unpack_bits(frame, offsets[k], offsets[k + 1], n)
        for k in range(nseg)
    ]
    if bits_allocated == 8:
        return planes[0].reshape(rows, cols)
    # big-endian composite: segment 0 = MSB, segment 1 = LSB (PS3.5 G.2)
    out = (planes[0].astype(np.uint16) << 8) | planes[1]
    return out.reshape(rows, cols)


def _pack_bits(seg: np.ndarray) -> bytes:
    """PackBits-encode one byte segment (for tests/fixtures).

    Standard greedy scheme: replicate runs of >=3 identical bytes, literal
    runs (max 128) otherwise. Output is padded to even length with a
    no-op-safe 0x00 pad byte as PS3.5 G.3.1 requires of every segment.
    """
    out = bytearray()
    n = len(seg)
    i = 0
    lit_start = i
    while i < n:
        run = 1
        while i + run < n and run < 128 and seg[i + run] == seg[i]:
            run += 1
        if run >= 3:
            while lit_start < i:  # flush pending literals
                cnt = min(128, i - lit_start)
                out.append(cnt - 1)
                out += seg[lit_start : lit_start + cnt].tobytes()
                lit_start += cnt
            out.append(257 - run)
            out.append(int(seg[i]))
            i += run
            lit_start = i
        else:
            i += run
    while lit_start < i:
        cnt = min(128, i - lit_start)
        out.append(cnt - 1)
        out += seg[lit_start : lit_start + cnt].tobytes()
        lit_start += cnt
    if len(out) % 2:
        out.append(0)
    return bytes(out)


def encode_rle_frame(img: np.ndarray, bits_allocated: int = 16) -> bytes:
    """Encode (rows, cols) uint8/uint16 -> one RLE frame fragment
    (64-byte header + PackBits segments), for round-trip tests."""
    img = np.ascontiguousarray(img)
    if bits_allocated == 16:
        img = img.astype(np.uint16)
        planes = [(img >> 8).astype(np.uint8), (img & 0xFF).astype(np.uint8)]
    elif bits_allocated == 8:
        planes = [img.astype(np.uint8)]
    else:
        raise ValueError(f"unsupported BitsAllocated {bits_allocated}")
    segs = [_pack_bits(p.reshape(-1)) for p in planes]
    header = [len(segs)]
    off = _HEADER_LEN
    for s in segs:
        header.append(off)
        off += len(s)
    header += [0] * (16 - len(header))
    return struct.pack("<16I", *header) + b"".join(segs)
