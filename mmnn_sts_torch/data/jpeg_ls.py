"""JPEG-LS (ITU-T T.87 / ISO 14495-1, LOCO-I) codec — pure python.

Completes the lossless compressed-DICOM coverage alongside JPEG Lossless
process 14 (data/jpeg_lossless.py) and RLE (data/dicom_rle.py): the
reference decoded JPEG-LS for free through SimpleITK/GDCM+CharLS
(reference data/s3utils.py:244-265), and JPEG-LS
(1.2.840.10008.1.2.4.80 lossless, .81 near-lossless) is the common
compressed CT/CR export. Implemented from the public T.87 spec; no code
is derived from CharLS, GDCM, or the reference.

Scope: single-component scans (ILV 0 — all DICOM grayscale), 2-16 bit,
NEAR >= 0 (lossless and near-lossless), LSE preset parameters
(MAXVAL/T1/T2/T3/RESET), both regular (context-modeled Golomb) and run
modes. Restart markers and DNL are rare in DICOM and raise clearly.

The encoder exists for golden round-trip tests and fixture generation —
decoder and encoder are written against the spec independently enough
that a transcription slip on either side breaks the round-trip suite
(tests/test_jpeg_ls.py), which also pins compression on runs and the
bit-stuffing boundary behavior.

The port's own copy of the JAX package's data/jpeg_ls.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from .codec_util import corrupt_stream_guard

SOI = 0xD8
EOI = 0xD9
SOF55 = 0xF7  # JPEG-LS frame header
LSE = 0xF8  # JPEG-LS preset parameters
SOS = 0xDA
DNL = 0xDC
DRI = 0xDD
COM = 0xFE

# run-length code order (T.87 A.2.1)
_J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)

_MIN_C, _MAX_C = -128, 127


class _Params:
    """Derived coding parameters (T.87 A.2.1 / C.2.4.1.1)."""

    def __init__(self, precision: int, near: int, maxval: int | None = None,
                 t1=None, t2=None, t3=None, reset=None):
        self.near = near
        self.maxval = maxval if maxval is not None else (1 << precision) - 1
        self.range = (self.maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range - 1).bit_length())
        self.bpp = max(2, (self.maxval).bit_length())
        self.limit = 2 * (self.bpp + max(8, self.bpp))
        self.reset = reset if reset is not None else 64

        # default thresholds (C.2.4.1.1.1), overridable via LSE
        mv, n = self.maxval, near
        if mv >= 128:
            factor = (min(mv, 4095) + 128) // 256
            d1 = factor * (3 - 2) + 2 + 3 * n
            d2 = factor * (7 - 3) + 3 + 5 * n
            d3 = factor * (21 - 4) + 4 + 7 * n
        else:
            factor = 256 // (mv + 1)
            d1 = max(2, 3 // factor + 3 * n)
            d2 = max(3, 7 // factor + 5 * n)
            d3 = max(4, 21 // factor + 7 * n)
        self.t1 = t1 if t1 is not None else max(n + 1, min(d1, mv))
        self.t2 = t2 if t2 is not None else max(self.t1, min(d2, mv))
        self.t3 = t3 if t3 is not None else max(self.t2, min(d3, mv))


class _State:
    """Adaptive context state: 365 regular + 2 run-interruption contexts."""

    def __init__(self, p: _Params):
        init_a = max(2, (p.range + 32) // 64)
        self.A = [init_a] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]  # negative-error counts for contexts 365/366
        self.run_index = 0


def _quantize_gradient(d: int, p: _Params) -> int:
    """T.87 A.3.3 gradient quantization to [-4, 4]."""
    if d <= -p.t3:
        return -4
    if d <= -p.t2:
        return -3
    if d <= -p.t1:
        return -2
    if d < -p.near:
        return -1
    if d <= p.near:
        return 0
    if d < p.t1:
        return 1
    if d < p.t2:
        return 2
    if d < p.t3:
        return 3
    return 4


def _predict(ra: int, rb: int, rc: int) -> int:
    """Median edge-detecting predictor (A.4.2)."""
    if rc >= max(ra, rb):
        return min(ra, rb)
    if rc <= min(ra, rb):
        return max(ra, rb)
    return ra + rb - rc


def _mod_range(errval: int, p: _Params) -> int:
    """A.4.5: reduce the (quantized) prediction error modulo RANGE."""
    if errval < 0:
        errval += p.range
    if errval >= (p.range + 1) // 2:
        errval -= p.range
    return errval


def _golomb_k(n: int, a: int) -> int:
    k = 0
    while (n << k) < a:
        k += 1
    return k


def _update_regular(st: _State, q: int, errval: int, p: _Params) -> None:
    """A.6: variable update + bias computation after a regular-mode sample."""
    st.B[q] += errval * (2 * p.near + 1)
    st.A[q] += abs(errval)
    if st.N[q] == p.reset:
        st.A[q] >>= 1
        st.B[q] >>= 1  # python arithmetic shift == A.6.1's negative halving
        st.N[q] >>= 1
    st.N[q] += 1
    if st.B[q] <= -st.N[q]:
        st.B[q] += st.N[q]
        if st.C[q] > _MIN_C:
            st.C[q] -= 1
        if st.B[q] <= -st.N[q]:
            st.B[q] = -st.N[q] + 1
    elif st.B[q] > 0:
        st.B[q] -= st.N[q]
        if st.C[q] < _MAX_C:
            st.C[q] += 1
        if st.B[q] > 0:
            st.B[q] = 0


def _ri_golomb_k(st: _State, ritype: int) -> int:
    """A.7.2.2: Golomb parameter for a run-interruption sample."""
    q = 365 + ritype
    temp = st.A[q] + ((st.N[q] >> 1) if ritype else 0)
    return _golomb_k(st.N[q], temp)


def _ri_update(st: _State, ritype: int, errval: int, emerrval: int,
               p: _Params) -> None:
    """A.7.2.4: run-interruption state update (+ run index decrement)."""
    q = 365 + ritype
    if errval < 0:
        st.Nn[ritype] += 1
    st.A[q] += (emerrval + 1 - ritype) >> 1
    if st.N[q] == p.reset:
        st.A[q] >>= 1
        st.N[q] >>= 1
        st.Nn[ritype] >>= 1
    st.N[q] += 1
    if st.run_index > 0:
        st.run_index -= 1


def _clamp_reconstruct(rx: int, p: _Params) -> int:
    """A.4.5 / A.7.2.1 reconstruction wrap + clamp to [0, MAXVAL]."""
    span = p.range * (2 * p.near + 1)
    if rx < -p.near:
        rx += span
    elif rx > p.maxval + p.near:
        rx -= span
    return min(max(rx, 0), p.maxval)


# ---------------------------------------------------------------------------
# Bit I/O with JPEG-LS marker-proof stuffing (a byte following 0xFF carries
# only 7 data bits, its MSB forced to 0 — T.87 A.1)
# ---------------------------------------------------------------------------


class _BitReader:
    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.cur = 0
        self.nbits = 0
        self.prev_ff = False

    def _fill(self) -> None:
        while self.nbits <= 24:
            if self.pos >= len(self.buf):
                self.cur = (self.cur << 8) & 0xFFFFFFFF
                self.nbits += 8
                continue
            byte = self.buf[self.pos]
            if self.prev_ff:
                if byte & 0x80:  # a real marker: stop consuming
                    self.cur = (self.cur << 8) & 0xFFFFFFFF
                    self.nbits += 8
                    continue
                self.pos += 1
                self.prev_ff = False
                self.cur = ((self.cur << 7) | byte) & 0xFFFFFFFF
                self.nbits += 7
            else:
                self.pos += 1
                self.prev_ff = byte == 0xFF
                self.cur = ((self.cur << 8) | byte) & 0xFFFFFFFF
                self.nbits += 8

    def read_bit(self) -> int:
        if self.nbits < 1:
            self._fill()
        self.nbits -= 1
        return (self.cur >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def unary(self) -> int:
        u = 0
        while self.read_bit() == 0:
            u += 1
            if u > 1 << 20:
                raise ValueError("JPEG-LS stream corrupt: runaway unary code")
        return u


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def _flush_bytes(self) -> None:
        while True:
            # stuffing: a byte following 0xFF carries only 7 data bits
            take = 7 if self.out and self.out[-1] == 0xFF else 8
            if self.nbits < take:
                break
            self.nbits -= take
            self.out.append((self.cur >> self.nbits) & ((1 << take) - 1))
        self.cur &= (1 << self.nbits) - 1

    def write_bits(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.cur = (self.cur << n) | (value & ((1 << n) - 1))
        self.nbits += n
        self._flush_bytes()

    def finish(self) -> bytes:
        if self.nbits:
            take = 7 if self.out and self.out[-1] == 0xFF else 8
            self.write_bits(0, take - self.nbits)  # zero pad to a byte
        return bytes(self.out)


def _golomb_encode(w: _BitWriter, value: int, k: int, limit: int,
                   qbpp: int) -> None:
    high = value >> k
    if high < limit - qbpp - 1:
        w.write_bits(0, high)  # `high` zeros
        w.write_bits(1, 1)
        w.write_bits(value, k)
    else:
        w.write_bits(0, limit - qbpp - 1)
        w.write_bits(1, 1)
        w.write_bits(value - 1, qbpp)


def _golomb_decode(r: _BitReader, k: int, limit: int, qbpp: int) -> int:
    u = r.unary()
    if u < limit - qbpp - 1:
        return (u << k) | r.read_bits(k)
    return r.read_bits(qbpp) + 1


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


@corrupt_stream_guard
def decode_jpeg_ls(buf: bytes) -> np.ndarray:
    """Decode a single-component JPEG-LS stream -> (rows, cols) uint16."""
    precision, rows, cols, pos, presets = _parse_headers(buf)
    near, ilv, pos = _parse_sos(buf, pos)
    if ilv != 0:
        raise ValueError(f"JPEG-LS interleave mode {ilv} unsupported "
                         "(DICOM grayscale is ILV 0)")
    p = _Params(precision, near, *presets)
    st = _State(p)
    r = _BitReader(buf, pos)

    out = np.empty((rows, cols), dtype=np.int64)
    prev = [0] * (cols + 2)
    for row in range(rows):
        cur = [0] * (cols + 2)
        cur[0] = prev[1]  # Ra of col 0 = Rb
        prev[cols + 1] = prev[cols]  # Rd of last col = its Rb
        col = 0
        while col < cols:
            ra, rb = cur[col], prev[col + 1]
            rc, rd = prev[col], prev[col + 2]
            d1, d2, d3 = rd - rb, rb - rc, rc - ra
            q1 = _quantize_gradient(d1, p)
            q2 = _quantize_gradient(d2, p)
            q3 = _quantize_gradient(d3, p)
            if q1 == 0 and q2 == 0 and q3 == 0:
                col = _decode_run(r, st, p, cur, prev, col, cols)
                continue
            q = q1 * 81 + q2 * 9 + q3
            sign = 1
            if q < 0:
                sign, q = -1, -q
            px = _predict(ra, rb, rc) + sign * st.C[q]
            px = min(max(px, 0), p.maxval)
            k = _golomb_k(st.N[q], st.A[q])
            merr = _golomb_decode(r, k, p.limit, p.qbpp)
            if p.near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                errval = (merr - 1) // 2 if merr & 1 else -(merr // 2) - 1
            else:
                errval = -((merr + 1) // 2) if merr & 1 else merr // 2
            _update_regular(st, q, errval, p)
            rx = px + sign * errval * (2 * p.near + 1)
            cur[col + 1] = _clamp_reconstruct(rx, p)
            col += 1
        out[row] = cur[1 : cols + 1]
        prev = cur
    return out.astype(np.uint16)


def _decode_run(r: _BitReader, st: _State, p: _Params, cur, prev,
                col: int, cols: int) -> int:
    """Run mode (A.7): fill with RUNval, then the interruption sample."""
    runval = cur[col]
    avail = cols - col
    while r.read_bit() == 1:
        seg = 1 << _J[st.run_index]
        cnt = min(seg, avail)
        for i in range(cnt):
            cur[col + 1 + i] = runval
        col += cnt
        avail -= cnt
        if cnt == seg and st.run_index < 31:
            st.run_index += 1
        if avail == 0:
            return col  # run reached end of line: no interruption sample
    if _J[st.run_index] > 0:
        rem = r.read_bits(_J[st.run_index])
        for i in range(rem):
            cur[col + 1 + i] = runval
        col += rem
        avail -= rem
    if avail <= 0:
        raise ValueError("JPEG-LS stream corrupt: run remainder overruns line")

    # run-interruption sample (A.7.2)
    ra, rb = cur[col], prev[col + 1]
    ritype = 1 if abs(ra - rb) <= p.near else 0
    px = ra if ritype else rb
    sign = -1 if (not ritype and ra > rb) else 1
    q = 365 + ritype
    k = _ri_golomb_k(st, ritype)
    emerr = _golomb_decode(r, k, p.limit - _J[st.run_index] - 1, p.qbpp)
    temp = emerr + ritype
    mapbit = temp & 1
    errvalabs = (temp + mapbit) // 2
    if (1 if (k != 0 or 2 * st.Nn[ritype] >= st.N[q]) else 0) == mapbit:
        errval = -errvalabs
    else:
        errval = errvalabs
    _ri_update(st, ritype, errval, emerr, p)
    rx = px + sign * errval * (2 * p.near + 1)
    cur[col + 1] = _clamp_reconstruct(rx, p)
    return col + 1


# ---------------------------------------------------------------------------
# Encoder (tests/fixtures)
# ---------------------------------------------------------------------------


def encode_jpeg_ls(img: np.ndarray, precision: int = 16,
                   near: int = 0) -> bytes:
    """Encode (rows, cols) unsigned samples as a JPEG-LS stream."""
    img = np.asarray(img, dtype=np.int64)
    rows, cols = img.shape
    p = _Params(precision, near)
    if img.min() < 0 or img.max() > p.maxval:
        raise ValueError(
            f"samples outside [0, {p.maxval}] for precision {precision}"
        )
    st = _State(p)
    w = _BitWriter()

    prev = [0] * (cols + 2)
    recon_prev = prev
    for row in range(rows):
        cur = [0] * (cols + 2)
        cur[0] = recon_prev[1]
        recon_prev[cols + 1] = recon_prev[cols]
        line = img[row]
        col = 0
        while col < cols:
            ra, rb = cur[col], recon_prev[col + 1]
            rc, rd = recon_prev[col], recon_prev[col + 2]
            q1 = _quantize_gradient(rd - rb, p)
            q2 = _quantize_gradient(rb - rc, p)
            q3 = _quantize_gradient(rc - ra, p)
            if q1 == 0 and q2 == 0 and q3 == 0:
                col = _encode_run(w, st, p, cur, recon_prev, line, col, cols)
                continue
            q = q1 * 81 + q2 * 9 + q3
            sign = 1
            if q < 0:
                sign, q = -1, -q
            px = _predict(ra, rb, rc) + sign * st.C[q]
            px = min(max(px, 0), p.maxval)
            errval = int(line[col]) - px
            if sign < 0:
                errval = -errval
            if p.near > 0:
                if errval > 0:
                    errval = (p.near + errval) // (2 * p.near + 1)
                else:
                    errval = -((p.near - errval) // (2 * p.near + 1))
            rx = px + sign * errval * (2 * p.near + 1)
            cur[col + 1] = _clamp_reconstruct(rx, p)
            errval = _mod_range(errval, p)
            k = _golomb_k(st.N[q], st.A[q])
            if p.near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                merr = 2 * errval if errval >= 0 else -2 * errval - 1
            _golomb_encode(w, merr, k, p.limit, p.qbpp)
            _update_regular(st, q, errval, p)
            col += 1
        recon_prev = cur

    return (_marker(SOI) + _frame_header(precision, rows, cols)
            + _scan_header(near) + w.finish() + _marker(EOI))


def _encode_run(w: _BitWriter, st: _State, p: _Params, cur, recon_prev,
                line, col: int, cols: int) -> int:
    runval = cur[col]
    start = col
    while col < cols and abs(int(line[col]) - runval) <= p.near:
        cur[col + 1] = runval
        col += 1
    runcnt = col - start
    while runcnt >= (1 << _J[st.run_index]):
        w.write_bits(1, 1)
        runcnt -= 1 << _J[st.run_index]
        if st.run_index < 31:
            st.run_index += 1
    if col == cols:
        if runcnt > 0:
            w.write_bits(1, 1)  # partial final segment at end of line
        return col
    w.write_bits(0, 1)
    w.write_bits(runcnt, _J[st.run_index])

    # run-interruption sample
    ra, rb = cur[col], recon_prev[col + 1]
    ritype = 1 if abs(ra - rb) <= p.near else 0
    px = ra if ritype else rb
    sign = -1 if (not ritype and ra > rb) else 1
    errval = (int(line[col]) - px) * sign
    if p.near > 0:
        if errval > 0:
            errval = (p.near + errval) // (2 * p.near + 1)
        else:
            errval = -((p.near - errval) // (2 * p.near + 1))
    rx = px + sign * errval * (2 * p.near + 1)
    cur[col + 1] = _clamp_reconstruct(rx, p)
    errval = _mod_range(errval, p)

    q = 365 + ritype
    k = _ri_golomb_k(st, ritype)
    if k == 0 and errval > 0 and 2 * st.Nn[ritype] < st.N[q]:
        mapbit = 1
    elif errval < 0 and (2 * st.Nn[ritype] >= st.N[q] or k != 0):
        mapbit = 1
    else:
        mapbit = 0
    emerr = 2 * abs(errval) - ritype - mapbit
    _golomb_encode(w, emerr, k, p.limit - _J[st.run_index] - 1, p.qbpp)
    _ri_update(st, ritype, errval, emerr, p)
    return col + 1


# ---------------------------------------------------------------------------
# Marker segments
# ---------------------------------------------------------------------------


def _marker(code: int) -> bytes:
    return bytes((0xFF, code))


def _frame_header(precision: int, rows: int, cols: int) -> bytes:
    body = bytes((precision,)) + rows.to_bytes(2, "big") \
        + cols.to_bytes(2, "big") + bytes((1, 1, 0x11, 0))
    return _marker(SOF55) + (len(body) + 2).to_bytes(2, "big") + body


def _scan_header(near: int) -> bytes:
    body = bytes((1, 1, 0)) + bytes((near, 0, 0))
    return _marker(SOS) + (len(body) + 2).to_bytes(2, "big") + body


def _parse_headers(buf: bytes):
    """Parse up to (not including) SOS; returns
    (precision, rows, cols, sos_pos, (maxval, t1, t2, t3, reset))."""
    if buf[:2] != bytes((0xFF, SOI)):
        raise ValueError("not a JPEG-LS stream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    presets = [None] * 5
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"expected marker at byte {pos}")
        code = buf[pos + 1]
        if code == SOS:
            if precision is None:
                raise ValueError("SOS before SOF55 frame header")
            return precision, rows, cols, pos, tuple(presets)
        seglen = int.from_bytes(buf[pos + 2 : pos + 4], "big")
        if pos + 2 + seglen > len(buf):
            raise ValueError("JPEG-LS stream truncated inside a marker segment")
        seg = buf[pos + 4 : pos + 2 + seglen]
        if code == SOF55:
            precision = seg[0]
            rows = int.from_bytes(seg[1:3], "big")
            cols = int.from_bytes(seg[3:5], "big")
            ncomp = seg[5]
            if ncomp != 1:
                raise ValueError(
                    f"JPEG-LS with {ncomp} components unsupported "
                    "(DICOM grayscale expected)"
                )
            if rows == 0:
                raise ValueError("JPEG-LS DNL (deferred height) unsupported")
        elif code == LSE:
            if seg[0] == 1:
                vals = [int.from_bytes(seg[1 + 2 * i : 3 + 2 * i], "big")
                        for i in range(5)]
                maxval, t1, t2, t3, reset = vals
                presets = [maxval or None, t1 or None, t2 or None,
                           t3 or None, reset or None]
            # other LSE ids (mapping tables, extensions) are skippable
        elif code == DRI:
            if int.from_bytes(seg[:2], "big") != 0:
                raise ValueError("JPEG-LS restart intervals unsupported")
        elif code in (COM,) or 0xE0 <= code <= 0xEF:
            pass  # comments / APPn: skip
        else:
            raise ValueError(f"unexpected JPEG-LS marker 0xFF{code:02X}")
        pos += 2 + seglen
    raise ValueError("JPEG-LS stream truncated before SOS")


def _parse_sos(buf: bytes, pos: int):
    seglen = int.from_bytes(buf[pos + 2 : pos + 4], "big")
    seg = buf[pos + 4 : pos + 2 + seglen]
    ns = seg[0]
    if ns != 1:
        raise ValueError(f"JPEG-LS scan with {ns} components unsupported")
    near = seg[1 + 2 * ns]
    ilv = seg[2 + 2 * ns]
    return near, ilv, pos + 2 + seglen
