"""JPEG Lossless (ITU-T T.81 process 14, SOF3) decoder — pure python.

The reference decodes compressed DICOM transfer syntaxes for
free through SimpleITK/GDCM (reference data/s3utils.py:244-265,
reference data/utils.py:16-37); the dominant compressed MRI export
is JPEG Lossless Non-Hierarchical First-Order Prediction
(1.2.840.10008.1.2.4.70 — process 14, selection value 1). This module
implements the full SOF3 decode (all predictors 1-7, point transform,
restart intervals, 2-16 bit precision) from the public T.81 spec; no code
is derived from GDCM or the reference.

This python implementation is the semantics oracle and the fallback; the
C++ fast path (native/mmnn_native.cpp:jpeg_lossless_decode, ~100x faster)
is used automatically when the native library is built — both are tested
against each other and against a from-scratch encoder round-trip
(tests/test_jpeg_lossless.py).

The port's own copy of the JAX package's data/jpeg_lossless.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from .codec_util import corrupt_stream_guard

SOI = 0xD8
EOI = 0xD9
SOF3 = 0xC3
DHT = 0xC4
SOS = 0xDA
DRI = 0xDD
RST0 = 0xD0
COM = 0xFE
APP0 = 0xE0


class _BitReader:
    """MSB-first bit reader over entropy-coded data with 0xFF00 byte
    unstuffing; stops at any non-stuffed marker."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.bit = 0
        self.cur = 0
        self.nbits = 0
        self.marker = None

    def _fill(self):
        while self.nbits <= 24:
            if self.pos >= len(self.buf):
                self.cur = (self.cur << 8) | 0
                self.nbits += 8
                continue
            b = self.buf[self.pos]
            if b == 0xFF:
                nxt = self.buf[self.pos + 1] if self.pos + 1 < len(self.buf) else 0
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7:  # RST marker: handled by caller
                    self.marker = nxt
                    self.cur = (self.cur << 8) | 0
                    self.nbits += 8
                    continue
                else:  # EOI or other marker — pad with zeros
                    self.marker = nxt
                    self.cur = (self.cur << 8) | 0
                    self.nbits += 8
                    continue
            else:
                self.pos += 1
            self.cur = (self.cur << 8) | b
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        val = (self.cur >> self.nbits) & ((1 << n) - 1)
        self.cur &= (1 << self.nbits) - 1
        return val

    def restart(self):
        """Consume the pending RST marker and re-align to a byte boundary."""
        # drop any padding bits + the zero-fill we may have injected
        self.cur = 0
        self.nbits = 0
        # scan forward to the RST marker bytes and skip them
        while self.pos + 1 < len(self.buf):
            if self.buf[self.pos] == 0xFF and 0xD0 <= self.buf[self.pos + 1] <= 0xD7:
                self.pos += 2
                self.marker = None
                return
            self.pos += 1
        raise ValueError("expected RST marker")


class _Huffman:
    """Canonical JPEG Huffman table -> fast (code-length-indexed) decoder."""

    def __init__(self, counts, symbols):
        self.maxcode = [-1] * 17
        self.mincode = [0] * 17
        self.valptr = [0] * 17
        self.symbols = list(symbols)
        code = 0
        k = 0
        for length in range(1, 17):
            n = counts[length - 1]
            if n:
                self.valptr[length] = k
                self.mincode[length] = code
                code += n
                k += n
                self.maxcode[length] = code - 1
            code <<= 1

    def decode(self, br: _BitReader) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | br.read(1)
            if self.maxcode[length] >= code >= self.mincode[length]:
                return self.symbols[self.valptr[length] + code - self.mincode[length]]
        raise ValueError("invalid Huffman code")


def _extend(v: int, t: int) -> int:
    """JPEG magnitude-category decode: v (t bits) -> signed difference."""
    if t == 0:
        return 0
    if t == 16:
        return 32768
    if v < (1 << (t - 1)):
        return v - (1 << t) + 1
    return v


@corrupt_stream_guard
def decode_jpeg_lossless(buf: bytes) -> np.ndarray:
    """Decode one SOF3 frame -> (rows, cols) or (rows, cols, components)
    uint16 array (point transform reversed by left-shift, per T.81 A.4)."""
    buf = bytes(buf)
    if buf[:2] != bytes((0xFF, SOI)):
        raise ValueError("not a JPEG stream (missing SOI)")
    pos = 2
    precision = rows = cols = 0
    ncomp = 0
    comp_ids = []
    huff = {}
    restart_interval = 0
    tables_for_comp = []
    predictor = 1
    point_transform = 0

    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"marker expected at {pos}")
        marker = buf[pos + 1]
        pos += 2
        if marker == EOI:
            break
        if RST0 <= marker <= RST0 + 7 or marker == SOI:
            continue
        seg_len = int.from_bytes(buf[pos:pos + 2], "big")
        seg = buf[pos + 2: pos + seg_len]
        if marker == SOF3:
            precision = seg[0]
            rows = int.from_bytes(seg[1:3], "big")
            cols = int.from_bytes(seg[3:5], "big")
            ncomp = seg[5]
            comp_ids = [seg[6 + 3 * i] for i in range(ncomp)]
        elif marker == DHT:
            off = 0
            while off < len(seg):
                tc_th = seg[off]
                counts = list(seg[off + 1: off + 17])
                nsym = sum(counts)
                symbols = list(seg[off + 17: off + 17 + nsym])
                huff[tc_th & 0x0F] = _Huffman(counts, symbols)
                off += 17 + nsym
        elif marker == DRI:
            restart_interval = int.from_bytes(seg[0:2], "big")
        elif marker == SOS:
            ns = seg[0]
            tables_for_comp = []
            for i in range(ns):
                cid = seg[1 + 2 * i]
                td = seg[2 + 2 * i] >> 4
                if cid not in comp_ids:
                    raise ValueError("SOS component not in frame")
                tables_for_comp.append(huff[td])
            predictor = seg[1 + 2 * ns]
            point_transform = seg[3 + 2 * ns] & 0x0F
            pos += seg_len
            return _decode_scan(
                buf, pos, rows, cols, ns, precision, predictor,
                point_transform, tables_for_comp, restart_interval,
            )
        pos += seg_len
    raise ValueError("no SOS marker found")


def _decode_scan(buf, pos, rows, cols, ncomp, precision, predictor,
                 point_transform, tables, restart_interval):
    """Entropy-coded scan -> samples.

    Prediction rules (T.81 H.1.2.1-H.1.2.3): the very first sample of the
    scan (and of each restart interval) predicts from 2^(P-Pt-1); the rest
    of the scan-start line predicts from Ra regardless of the selection
    value; the first sample of every later line predicts from Rb; all other
    samples use the selected predictor. Differences are mod-2^16.
    """
    br = _BitReader(buf, pos)
    out = np.zeros((rows, cols, ncomp), dtype=np.int32)
    default = 1 << (precision - point_transform - 1)
    maxval = (1 << 16) - 1
    mcu = 0  # MCUs (pixel positions) since last restart
    seg_r, seg_c = 0, 0  # position where the current scan segment began

    for r in range(rows):
        for c in range(cols):
            if restart_interval and mcu == restart_interval:
                br.restart()
                mcu = 0
                seg_r, seg_c = r, c
            for comp in range(ncomp):
                t = tables[comp].decode(br)
                # category 16 appends NO magnitude bits (diff is 32768,
                # T.81 H.1.2.2); categories 1-15 append t bits
                diff = _extend(br.read(t) if 0 < t < 16 else 0, t)
                if (r, c) == (seg_r, seg_c):
                    px = default  # segment start (T.81 H.2.2)
                elif r == seg_r:
                    px = int(out[r, c - 1, comp])  # segment's first line: Ra
                elif c == 0:
                    px = int(out[r - 1, c, comp])  # Rb for first column
                else:
                    ra = int(out[r, c - 1, comp])
                    rb = int(out[r - 1, c, comp])
                    rc_ = int(out[r - 1, c - 1, comp])
                    if predictor == 1:
                        px = ra
                    elif predictor == 2:
                        px = rb
                    elif predictor == 3:
                        px = rc_
                    elif predictor == 4:
                        px = ra + rb - rc_
                    elif predictor == 5:
                        px = ra + ((rb - rc_) >> 1)
                    elif predictor == 6:
                        px = rb + ((ra - rc_) >> 1)
                    elif predictor == 7:
                        px = (ra + rb) >> 1
                    else:
                        raise ValueError(f"bad predictor {predictor}")
                out[r, c, comp] = (px + diff) & maxval
            mcu += 1
    if point_transform:
        out <<= point_transform
    out = out.astype(np.uint16)
    return out[:, :, 0] if ncomp == 1 else out


# ---------------------------------------------------------------------------
# Encoder (fixtures/tests only): SV1, single component, no restarts
# ---------------------------------------------------------------------------


def _category(diff: int) -> int:
    if diff == 32768:
        return 16
    mag = abs(diff)
    t = 0
    while mag:
        mag >>= 1
        t += 1
    return t


class _BitWriter:
    def __init__(self):
        self.bytes_ = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, val: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((val >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.bytes_.append(self.acc)
                if self.acc == 0xFF:
                    self.bytes_.append(0x00)  # byte stuffing
                self.acc = 0
                self.n = 0

    def flush(self):
        if self.n:
            self.acc <<= 8 - self.n
            self.acc |= (1 << (8 - self.n)) - 1  # pad with 1s (convention)
            self.bytes_.append(self.acc)
            if self.acc == 0xFF:
                self.bytes_.append(0x00)
            self.acc = 0
            self.n = 0


def encode_jpeg_lossless_sv1(img: np.ndarray, precision: int = 16,
                             predictor: int = 1) -> bytes:
    """Minimal SOF3 encoder (one component) used by the test fixtures;
    produces streams any conformant decoder accepts. Default selection
    value 1; other predictors supported for decoder coverage."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("encoder supports single-component images")
    rows, cols = img.shape
    img = img.astype(np.int64) & 0xFFFF

    def predict(r, c):
        if r == 0 and c == 0:
            return 1 << (precision - 1)
        if r == 0:
            return int(img[0, c - 1])
        if c == 0:
            return int(img[r - 1, 0])
        ra, rb, rc_ = int(img[r, c - 1]), int(img[r - 1, c]), int(img[r - 1, c - 1])
        return {
            1: ra, 2: rb, 3: rc_, 4: ra + rb - rc_,
            5: ra + ((rb - rc_) >> 1), 6: rb + ((ra - rc_) >> 1),
            7: (ra + rb) >> 1,
        }[predictor]

    diffs = []
    for r in range(rows):
        for c in range(cols):
            d = int(img[r, c]) - predict(r, c)
            # mod-2^16 wrap into [-32767, 32768]
            d = ((d + 32768) & 0xFFFF) - 32768
            if d == -32768:
                d = 32768
            diffs.append(d)

    # canonical Huffman table over used categories: simple fixed-length-ish
    cats = sorted({_category(d) for d in diffs})
    counts = [0] * 16
    # assign all used categories codes of the same length L (smallest valid)
    L = max(1, (len(cats)).bit_length())
    if (1 << L) == len(cats):  # all-ones code would be ambiguous-safe anyway
        L += 1
    counts[L - 1] = len(cats)
    symbols = cats
    table = _Huffman(counts, symbols)
    # build encode map from the same canonical assignment
    enc = {}
    code = 0
    k = 0
    for length in range(1, 17):
        n = counts[length - 1]
        for _ in range(n):
            enc[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1

    def seg(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    sof = bytes([precision]) + rows.to_bytes(2, "big") + cols.to_bytes(2, "big") \
        + bytes([1, 1, 0x11, 0])
    dht = bytes([0x00]) + bytes(counts) + bytes(symbols)
    sos = bytes([1, 1, 0x00, predictor, 0, 0x00])  # Ss=predictor, Ah/Al=0

    bw = _BitWriter()
    for d in diffs:
        t = _category(d)
        code, length = enc[t]
        bw.write(code, length)
        if t and t != 16:
            v = d if d >= 0 else d + (1 << t) - 1
            bw.write(v & ((1 << t) - 1), t)
    bw.flush()

    return (bytes([0xFF, SOI]) + seg(SOF3, sof) + seg(DHT, dht)
            + seg(SOS, sos) + bytes(bw.bytes_) + bytes([0xFF, EOI]))
