"""JPEG baseline / extended sequential DCT codec (ITU-T T.81) — pure python.

The last compressed-DICOM corner: transfer syntaxes 1.2.840.10008.1.2.4.50
(JPEG Baseline, 8-bit) and .51 (Extended sequential, 12-bit) are LOSSY DCT
processes. The reference decoded them implicitly through SimpleITK/GDCM+
libjpeg (reference data/s3utils.py:244-265) and trained on whatever
came out; this module does the same, written from the public T.81 spec (no
libjpeg/GDCM code).

Caveat recorded in PARITY.md: T.81 does not mandate a bit-exact IDCT, so
lossy decodes may differ from libjpeg by ±1-2 sample values — meaningless
relative to the quantization loss already present in such exports. Lossless
syntaxes (where exactness matters) have their own exact codecs.

Scope: single-component (DICOM grayscale) sequential scans, 8-bit (SOF0)
and 12-bit (SOF1), restart intervals, standard or custom Huffman/quant
tables. Progressive (SOF2), arithmetic coding, and multi-component scans
raise clearly. The encoder exists for golden round-trip tests (quantizer
table of ones bounds the loss to DCT roundoff) and fixture generation.

The port's own copy of the JAX package's data/jpeg_baseline.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from .codec_util import corrupt_stream_guard

# zigzag order (T.81 Figure 5)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# 8x8 DCT basis: A[k, n] = c(k) * cos((2n+1) k pi / 16); X = A x A^T
_A = np.zeros((8, 8))
for _k in range(8):
    _c = np.sqrt(1 / 8) if _k == 0 else np.sqrt(2 / 8)
    for _n in range(8):
        _A[_k, _n] = _c * np.cos((2 * _n + 1) * _k * np.pi / 16)


def _idct2(block: np.ndarray) -> np.ndarray:
    return _A.T @ block @ _A


def _fdct2(block: np.ndarray) -> np.ndarray:
    return _A @ block @ _A.T


class _HuffTable:
    """Canonical Huffman table from the DHT (counts, symbols) encoding."""

    def __init__(self, counts, symbols):
        self.maxcode = [-1] * 17
        self.mincode = [0] * 17
        self.valptr = [0] * 17
        self.symbols = list(symbols)
        code = 0
        k = 0
        for ln in range(1, 17):
            c = counts[ln - 1]
            if c:
                self.valptr[ln] = k
                self.mincode[ln] = code
                code += c
                k += c
                self.maxcode[ln] = code - 1
            code <<= 1
        # encoder view: symbol -> (code, length)
        self.enc = {}
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(counts[ln - 1]):
                self.enc[symbols[k]] = (code, ln)
                code += 1
                k += 1
            code <<= 1

    def decode(self, r) -> int:
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | r.read_bit()
            if self.maxcode[ln] >= code >= self.mincode[ln]:
                return self.symbols[self.valptr[ln] + code - self.mincode[ln]]
        raise ValueError("JPEG stream corrupt: invalid Huffman code")


def _extend(v: int, t: int) -> int:
    """T.81 F.12 sign extension of a t-bit magnitude code."""
    if t == 0:
        return 0
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


class _BitReader:
    """Entropy-segment reader: 0xFF00 destuffing, stops at markers."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.cur = 0
        self.nbits = 0

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.buf):
                raise ValueError("JPEG stream truncated in entropy data")
            b = self.buf[self.pos]
            if b == 0xFF:
                nxt = self.buf[self.pos + 1] if self.pos + 1 < len(self.buf) \
                    else 0xD9
                if nxt == 0x00:
                    self.pos += 2  # stuffed literal 0xFF data byte
                    self.cur = 0xFF
                else:
                    self.cur = 0xFF  # marker: pad with 1s, don't consume
            else:
                self.pos += 1
                self.cur = b
            self.nbits = 8
        self.nbits -= 1
        return (self.cur >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def restart(self) -> None:
        """Byte-align and skip the RSTn marker."""
        self.nbits = 0
        while self.pos + 1 < len(self.buf):
            if self.buf[self.pos] == 0xFF and \
                    0xD0 <= self.buf[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1
        raise ValueError("JPEG stream corrupt: missing restart marker")


@corrupt_stream_guard
def decode_jpeg_baseline(buf: bytes) -> np.ndarray:
    """Decode a single-component sequential-DCT JPEG -> (rows, cols) int."""
    buf = bytes(buf)
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    qtables: dict[int, np.ndarray] = {}
    dc_tables: dict[int, _HuffTable] = {}
    ac_tables: dict[int, _HuffTable] = {}
    restart_interval = 0
    comp_q = 0
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"expected marker at byte {pos}")
        code = buf[pos + 1]
        if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:
            pos += 2
            continue
        seglen = int.from_bytes(buf[pos + 2 : pos + 4], "big")
        seg = buf[pos + 4 : pos + 2 + seglen]
        if code in (0xC0, 0xC1):  # SOF0 baseline / SOF1 extended
            precision = seg[0]
            rows = int.from_bytes(seg[1:3], "big")
            cols = int.from_bytes(seg[3:5], "big")
            ncomp = seg[5]
            if ncomp != 1:
                raise ValueError(
                    f"lossy JPEG with {ncomp} components unsupported "
                    "(DICOM grayscale expected)"
                )
            if seg[7] != 0x11:
                raise ValueError("JPEG subsampling unsupported for 1 comp")
            comp_q = seg[8]
        elif code in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                      0xCD, 0xCE, 0xCF):
            raise ValueError(
                f"JPEG SOF 0x{code:02X} unsupported (progressive/arithmetic/"
                "hierarchical); sequential baseline or extended expected"
            )
        elif code == 0xC4:  # DHT
            off = 0
            while off < len(seg):
                tc, th = seg[off] >> 4, seg[off] & 0x0F
                counts = list(seg[off + 1 : off + 17])
                n = sum(counts)
                table = _HuffTable(counts, seg[off + 17 : off + 17 + n])
                (dc_tables if tc == 0 else ac_tables)[th] = table
                off += 17 + n
        elif code == 0xDB:  # DQT
            off = 0
            while off < len(seg):
                pq, tq = seg[off] >> 4, seg[off] & 0x0F
                if pq:
                    vals = np.frombuffer(seg[off + 1 : off + 129],
                                         dtype=">u2").astype(np.int64)
                    off += 129
                else:
                    vals = np.frombuffer(seg[off + 1 : off + 65],
                                         dtype=np.uint8).astype(np.int64)
                    off += 65
                qtables[tq] = vals
        elif code == 0xDD:  # DRI
            restart_interval = int.from_bytes(seg[:2], "big")
        elif code == 0xDA:  # SOS
            if precision is None:
                raise ValueError("JPEG SOS before SOF")
            ns = seg[0]
            if ns != 1:
                raise ValueError("multi-component JPEG scan unsupported")
            dc_id, ac_id = seg[2] >> 4, seg[2] & 0x0F
            return _decode_scan(
                buf, pos + 2 + seglen, rows, cols, precision,
                qtables[comp_q], dc_tables[dc_id], ac_tables[ac_id],
                restart_interval,
            )
        elif code == 0xD9:  # EOI
            break
        # APPn / COM / others: skip
        pos += 2 + seglen
    raise ValueError("JPEG stream has no scan")


def _decode_scan(buf, pos, rows, cols, precision, qt, dc_t, ac_t,
                 restart_interval) -> np.ndarray:
    bx = (cols + 7) // 8
    by = (rows + 7) // 8
    out = np.zeros((by * 8, bx * 8), np.int64)
    r = _BitReader(buf, pos)
    pred = 0
    mcu = 0
    deq = np.zeros(64, np.int64)
    for yb in range(by):
        for xb in range(bx):
            if restart_interval and mcu == restart_interval:
                r.restart()
                pred = 0
                mcu = 0
            t = dc_t.decode(r)
            pred += _extend(r.read_bits(t), t) if t else 0
            deq[:] = 0
            deq[0] = pred * qt[0]
            k = 1
            while k < 64:
                rs = ac_t.decode(r)
                rr, ss = rs >> 4, rs & 0x0F
                if ss == 0:
                    if rr == 15:
                        k += 16  # ZRL
                        continue
                    break  # EOB
                k += rr
                if k > 63:
                    raise ValueError("JPEG stream corrupt: AC index overrun")
                deq[k] = _extend(r.read_bits(ss), ss) * qt[k]
                k += 1
            block = np.zeros(64, np.int64)
            block[ZIGZAG] = deq
            pix = _idct2(block.reshape(8, 8))
            out[yb * 8 : yb * 8 + 8, xb * 8 : xb * 8 + 8] = \
                np.round(pix).astype(np.int64)
            mcu += 1
    shift = 1 << (precision - 1)
    return np.clip(out[:rows, :cols] + shift, 0, (1 << precision) - 1)


# ---------------------------------------------------------------------------
# Encoder (tests/fixtures). Uses flat canonical Huffman tables (all DC
# symbols 5 bits, all AC symbols 9 bits) — valid, inefficient, and depth-
# agnostic, which the standard K.3 tables are not (they stop at 8-bit
# categories).
# ---------------------------------------------------------------------------


def _flat_tables(precision: int):
    ndc = 12 if precision == 8 else 16
    dc_counts = [0] * 16
    dc_counts[4] = ndc if ndc <= 16 else 0
    if ndc > 16:
        raise ValueError("unsupported precision")
    dc_syms = list(range(ndc))
    ac_syms = []
    for rr in range(16):
        for ss in range(16):
            if ss == 0 and rr not in (0, 15):
                continue
            ac_syms.append((rr << 4) | ss)
    ac_counts = [0] * 16
    ac_counts[9] = len(ac_syms)  # 10-bit codes: 226 symbols < 2^10 - 1
    return (dc_counts, dc_syms), (ac_counts, ac_syms)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((v >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.cur)
                if self.cur == 0xFF:
                    self.out.append(0x00)  # stuffing
                self.cur = 0
                self.nbits = 0

    def byte_align(self) -> None:
        if self.nbits:
            self.write_bits((1 << (8 - self.nbits)) - 1, 8 - self.nbits)

    def marker(self, code: int) -> None:
        self.byte_align()
        self.out += bytes((0xFF, code))

    def finish(self) -> bytes:
        self.byte_align()
        return bytes(self.out)


def encode_jpeg_baseline(img: np.ndarray, precision: int = 8,
                         quant: int = 1, restart_interval: int = 0) -> bytes:
    """Encode (rows, cols) unsigned samples as sequential-DCT JPEG.
    quant=1 (a flat all-ones table) bounds the loss to DCT roundoff."""
    img = np.asarray(img, np.int64)
    rows, cols = img.shape
    if img.min() < 0 or img.max() > (1 << precision) - 1:
        raise ValueError(f"samples out of range for precision {precision}")
    qt = np.full(64, quant, np.int64)
    (dcc, dcs), (acc, acs) = _flat_tables(precision)
    dc_t = _HuffTable(dcc, dcs)
    ac_t = _HuffTable(acc, acs)

    shift = 1 << (precision - 1)
    bx = (cols + 7) // 8
    by = (rows + 7) // 8
    padded = np.pad(img, ((0, by * 8 - rows), (0, bx * 8 - cols)),
                    mode="edge") - shift
    w = _BitWriter()
    pred = 0
    mcu = 0
    rst = 0
    for yb in range(by):
        for xb in range(bx):
            if restart_interval and mcu == restart_interval:
                w.marker(0xD0 + rst)
                rst = (rst + 1) % 8
                pred = 0
                mcu = 0
            mcu += 1
            block = _fdct2(padded[yb * 8 : yb * 8 + 8,
                                  xb * 8 : xb * 8 + 8].astype(np.float64))
            # zigzag-ordered quantized coefficients (DQT is zigzag-ordered)
            zz = np.round(block.reshape(64)[ZIGZAG] / qt).astype(np.int64)
            diff = int(zz[0]) - pred
            pred = int(zz[0])
            t = abs(diff).bit_length()
            code, ln = dc_t.enc[t]
            w.write_bits(code, ln)
            if t:
                w.write_bits(diff if diff >= 0 else diff + (1 << t) - 1, t)
            run = 0
            for k in range(1, 64):
                v = int(zz[k])
                if v == 0:
                    run += 1
                    continue
                while run >= 16:
                    code, ln = ac_t.enc[0xF0]
                    w.write_bits(code, ln)
                    run -= 16
                ss = abs(v).bit_length()
                code, ln = ac_t.enc[(run << 4) | ss]
                w.write_bits(code, ln)
                w.write_bits(v if v >= 0 else v + (1 << ss) - 1, ss)
                run = 0
            if run:
                code, ln = ac_t.enc[0x00]
                w.write_bits(code, ln)

    def seg(marker, body):
        return bytes((0xFF, marker)) + (len(body) + 2).to_bytes(2, "big") \
            + body

    dqt = seg(0xDB, bytes((0x10,)) + b"".join(
        int(v).to_bytes(2, "big") for v in qt))
    sof_code = 0xC0 if precision == 8 else 0xC1
    sof = seg(sof_code, bytes((precision,)) + rows.to_bytes(2, "big")
              + cols.to_bytes(2, "big") + bytes((1, 1, 0x11, 0)))
    dht = seg(0xC4, bytes((0x00,)) + bytes(dcc) + bytes(dcs)
              + bytes((0x10,)) + bytes(acc) + bytes(acs))
    dri = seg(0xDD, restart_interval.to_bytes(2, "big")) \
        if restart_interval else b""
    sos = seg(0xDA, bytes((1, 1, 0x00, 0, 63, 0)))
    return (b"\xff\xd8" + dqt + sof + dht + dri + sos + w.finish()
            + b"\xff\xd9")
