"""JPEG 2000 Part 1 (ITU-T T.800 / ISO 15444-1) codec — pure python.

Completes the compressed-DICOM coverage alongside JPEG Lossless
process 14 (data/jpeg_lossless.py), RLE (data/dicom_rle.py) and JPEG-LS
(data/jpeg_ls.py): the reference decoded JPEG 2000 for free through
SimpleITK/GDCM+OpenJPEG (reference data/s3utils.py:244-265);
1.2.840.10008.1.2.4.90 (J2K lossless) is a common PACS archive syntax and
.91 (J2K, possibly lossy) a common teleradiology export.
Written from the public T.800 spec; no code from OpenJPEG, Kakadu, or GDCM.

Decoder scope (the shape of real DICOM mono exports):
- single component, single tile, zero image/tile offsets
- reversible 5/3 wavelet with no quantization, AND irreversible 9/7
  wavelet with scalar quantization (derived or expounded), midpoint
  reconstruction of partially-decoded coefficients — like the lossy
  sequential-DCT JPEG syntaxes (.50/.51), lossy decodes match the
  OpenJPEG/GDCM result within float rounding, not bit-exactly (T.800
  mandates no exact real-arithmetic result)
- default precincts (one per resolution), any code-block size
- any number of layers and decomposition levels; all five progression
  orders (they coincide for single-component/single-precinct streams)
- SOP/EPH marker segments tolerated; raw codestream or JP2 container
- code-block style 0 (no bypass/reset/termination/causal/segmentation),
  which is the OpenJPEG and Kakadu default

Anything else raises with a clear message so the caller can fall back to
converting the export. The encoder exists for golden round-trip tests and
fixture generation; encoder and decoder share the T1 context model but are
written against the spec independently enough that a transcription slip
breaks the round-trip suite (tests/test_jpeg2000.py).

The port's own copy of the JAX package's data/jpeg2000.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from .j2k_mq import CTX_RL, CTX_UNI, MQDecoder, MQEncoder

from .codec_util import corrupt_stream_guard

# main codestream markers (T.800 Annex A)
SOC = 0xFF4F
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PLM = 0xFF57
PLT = 0xFF58
PPM = 0xFF60
PPT = 0xFF61
TLM = 0xFF55
CRG = 0xFF63
COM = 0xFF64
SOT = 0xFF90
SOP = 0xFF91
EPH = 0xFF92
SOD = 0xFF93
EOC = 0xFFD9

_JP2_SIGNATURE = bytes.fromhex("0000000C6A5020200D0A870A")

_UNKNOWN = 1 << 30  # tag-tree "value not yet determined" sentinel


# ---------------------------------------------------------------------------
# Tag trees (B.10.2) — quad-tree coded minima for packet-header inclusion
# and zero-bitplane signalling. Level 0 = leaves; parents halve each dim.
# ---------------------------------------------------------------------------


class TagTree:
    def __init__(self, w: int, h: int):
        self.dims = [(w, h)]
        while w > 1 or h > 1:
            w = (w + 1) // 2
            h = (h + 1) // 2
            self.dims.append((w, h))
        self.nlev = len(self.dims)
        self.value = [np.full((d[1], d[0]), _UNKNOWN, np.int64)
                      for d in self.dims]
        self.low = [np.zeros((d[1], d[0]), np.int64) for d in self.dims]
        self.known = [np.zeros((d[1], d[0]), bool) for d in self.dims]

    def set_values(self, leaves: np.ndarray) -> None:
        """Encoder side: fill leaf values and propagate minima upward."""
        self.value[0][:, :] = leaves
        for lev in range(1, self.nlev):
            w, h = self.dims[lev]
            below = self.value[lev - 1]
            for y in range(h):
                for x in range(w):
                    self.value[lev][y, x] = below[2 * y : 2 * y + 2,
                                                  2 * x : 2 * x + 2].min()

    def encode(self, bits: list, x: int, y: int, threshold: int) -> None:
        """Append the bits answering 'value(x, y) < threshold?'."""
        low = 0
        for lev in range(self.nlev - 1, -1, -1):
            nx, ny = x >> lev, y >> lev
            if low > self.low[lev][ny, nx]:
                self.low[lev][ny, nx] = low
            else:
                low = int(self.low[lev][ny, nx])
            v = int(self.value[lev][ny, nx])
            while low < threshold:
                if low >= v:
                    if not self.known[lev][ny, nx]:
                        bits.append(1)
                        self.known[lev][ny, nx] = True
                    break
                bits.append(0)
                low += 1
            self.low[lev][ny, nx] = low

    def decode(self, reader, x: int, y: int, threshold: int) -> bool:
        """True iff value(x, y) < threshold, consuming header bits."""
        low = 0
        v = _UNKNOWN
        for lev in range(self.nlev - 1, -1, -1):
            nx, ny = x >> lev, y >> lev
            if low > self.low[lev][ny, nx]:
                self.low[lev][ny, nx] = low
            else:
                low = int(self.low[lev][ny, nx])
            v = int(self.value[lev][ny, nx])
            while low < threshold and low < v:
                if reader.read_bit():
                    v = low
                    self.value[lev][ny, nx] = low
                else:
                    low += 1
            self.low[lev][ny, nx] = low
        return v < threshold

    def leaf_value(self, x: int, y: int) -> int:
        return int(self.value[0][y, x])


# ---------------------------------------------------------------------------
# Reversible 5/3 wavelet (Annex F). Zero image/tile offsets mean every
# signal starts on an even coordinate, so only the even-start (cas 0) phase
# is needed. Boundary handling is the spec's whole-sample symmetric
# extension, which for the lifting steps reduces to clamping the neighbor
# index into range. Synthesis order per level is HOR then VER (F.3.4) —
# matching real decoders bit-for-bit matters because the floors make the
# two orders inequivalent.
# ---------------------------------------------------------------------------


def _dwt53_split_1d(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """1D analysis along the last axis -> (low, high)."""
    n = x.shape[-1]
    x = x.astype(np.int64)
    if n == 1:
        return x.copy(), x[..., :0].copy()
    xe = x[..., 0::2]
    xo = x[..., 1::2]
    ne, no = xe.shape[-1], xo.shape[-1]
    # d[k] = x[2k+1] - ((x[2k] + x[2k+2]) >> 1), neighbor clamped at the edge
    if ne == no:
        right = np.concatenate([xe[..., 1:], xe[..., -1:]], axis=-1)
    else:
        right = xe[..., 1:]
    d = xo - ((xe[..., :no] + right) >> 1)
    # s[k] = x[2k] + ((d[k-1] + d[k] + 2) >> 2), d clamped at both edges
    dm1 = np.concatenate([d[..., :1], d], axis=-1)[..., :ne]
    dk = d if no == ne else np.concatenate([d, d[..., -1:]], axis=-1)
    s = xe + ((dm1 + dk[..., :ne] + 2) >> 2)
    return s, d


def _dwt53_merge_1d(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    """1D synthesis along the last axis; inverse of _dwt53_split_1d."""
    ne, no = s.shape[-1], d.shape[-1]
    n = ne + no
    s = s.astype(np.int64)
    if n == 1:
        return s.copy()
    d = d.astype(np.int64)
    dm1 = np.concatenate([d[..., :1], d], axis=-1)[..., :ne]
    dk = d if no == ne else np.concatenate([d, d[..., -1:]], axis=-1)
    xe = s - ((dm1 + dk[..., :ne] + 2) >> 2)
    if ne == no:
        right = np.concatenate([xe[..., 1:], xe[..., -1:]], axis=-1)
    else:
        right = xe[..., 1:]
    xo = d + ((xe[..., :no] + right) >> 1)
    out = np.empty(s.shape[:-1] + (n,), np.int64)
    out[..., 0::2] = xe
    out[..., 1::2] = xo
    return out


def dwt53_forward(img: np.ndarray, levels: int):
    """-> (LL_n, [(HL_l, LH_l, HH_l) for l = n..1], coarsest first).

    Analysis is VER then HOR per level (the adjoint of the HOR-then-VER
    synthesis order of F.3.4).
    """
    ll = np.asarray(img, np.int64)
    bands = []
    for _ in range(levels):
        if ll.shape[-1] < 1 or ll.shape[-2] < 1:
            raise ValueError("too many DWT levels for image size")
        # vertical split (along y = axis -2)
        lo_y, hi_y = _dwt53_split_1d(ll.swapaxes(-1, -2))
        lo_y = lo_y.swapaxes(-1, -2)
        hi_y = hi_y.swapaxes(-1, -2)
        # horizontal split (along x = axis -1)
        ll, hl = _dwt53_split_1d(lo_y)
        lh, hh = _dwt53_split_1d(hi_y)
        bands.append((hl, lh, hh))
    return ll, bands[::-1]


def dwt53_inverse(ll: np.ndarray, bands) -> np.ndarray:
    """Inverse of dwt53_forward; `bands` coarsest-first. Synthesis is HOR
    then VER per level, matching T.800 F.3.4 / real-world decoders."""
    ll = np.asarray(ll, np.int64)
    for hl, lh, hh in bands:
        lo_y = _dwt53_merge_1d(ll, hl)
        hi_y = _dwt53_merge_1d(lh, hh)
        ll = _dwt53_merge_1d(lo_y.swapaxes(-1, -2),
                             hi_y.swapaxes(-1, -2)).swapaxes(-1, -2)
    return ll


# ---------------------------------------------------------------------------
# Irreversible 9/7 wavelet (Annex F, Table F.4). Same even-start /
# clamped-neighbor symmetric extension as the 5/3 above, in float64.
# Analysis scales the lowpass by 1/K and the highpass by K (the spec's
# 1D_SD steps 5-6); synthesis undoes that before un-lifting — the
# convention is pinned by the OpenJPEG interop tests (a swapped or
# missing scale step is off by K^2 per level and fails them wildly).
# ---------------------------------------------------------------------------

_A97 = -1.586134342059924  # lifting steps 1-4 (T.800 Table F.4)
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _odd_neighbors(e: np.ndarray, no: int):
    """(left, right) even neighbors of each odd sample, edge-clamped."""
    if e.shape[-1] == no:
        right = np.concatenate([e[..., 1:], e[..., -1:]], axis=-1)
    else:
        right = e[..., 1:]
    return e[..., :no], right


def _even_neighbors(d: np.ndarray, ne: int):
    """(left, right) odd neighbors of each even sample, edge-clamped."""
    dm1 = np.concatenate([d[..., :1], d], axis=-1)[..., :ne]
    dk = d if d.shape[-1] == ne else np.concatenate([d, d[..., -1:]], axis=-1)
    return dm1, dk[..., :ne]


def _dwt97_split_1d(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """1D 9/7 analysis along the last axis -> (low, high), float64."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if n == 1:
        return x.copy(), x[..., :0].copy()
    e = x[..., 0::2].copy()
    o = x[..., 1::2].copy()
    ne, no = e.shape[-1], o.shape[-1]
    l, r = _odd_neighbors(e, no)
    o += _A97 * (l + r)
    l, r = _even_neighbors(o, ne)
    e += _B97 * (l + r)
    l, r = _odd_neighbors(e, no)
    o += _G97 * (l + r)
    l, r = _even_neighbors(o, ne)
    e += _D97 * (l + r)
    return e * (1.0 / _K97), o * _K97


def _dwt97_merge_1d(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    """1D 9/7 synthesis along the last axis; inverse of _dwt97_split_1d."""
    ne, no = s.shape[-1], d.shape[-1]
    n = ne + no
    s = np.asarray(s, np.float64)
    if n == 1:
        return s.copy()
    e = s * _K97
    o = np.asarray(d, np.float64) * (1.0 / _K97)
    l, r = _even_neighbors(o, ne)
    e = e - _D97 * (l + r)
    l, r = _odd_neighbors(e, no)
    o = o - _G97 * (l + r)
    l, r = _even_neighbors(o, ne)
    e = e - _B97 * (l + r)
    l, r = _odd_neighbors(e, no)
    o = o - _A97 * (l + r)
    out = np.empty(s.shape[:-1] + (n,), np.float64)
    out[..., 0::2] = e
    out[..., 1::2] = o
    return out


def dwt97_forward(img: np.ndarray, levels: int):
    """Float 9/7 analogue of dwt53_forward (VER then HOR per level)."""
    ll = np.asarray(img, np.float64)
    bands = []
    for _ in range(levels):
        if ll.shape[-1] < 1 or ll.shape[-2] < 1:
            raise ValueError("too many DWT levels for image size")
        lo_y, hi_y = _dwt97_split_1d(ll.swapaxes(-1, -2))
        lo_y = lo_y.swapaxes(-1, -2)
        hi_y = hi_y.swapaxes(-1, -2)
        ll, hl = _dwt97_split_1d(lo_y)
        lh, hh = _dwt97_split_1d(hi_y)
        bands.append((hl, lh, hh))
    return ll, bands[::-1]


def dwt97_inverse(ll: np.ndarray, bands) -> np.ndarray:
    """Inverse of dwt97_forward; `bands` coarsest-first, HOR then VER."""
    ll = np.asarray(ll, np.float64)
    for hl, lh, hh in bands:
        lo_y = _dwt97_merge_1d(ll, hl)
        hi_y = _dwt97_merge_1d(lh, hh)
        ll = _dwt97_merge_1d(lo_y.swapaxes(-1, -2),
                             hi_y.swapaxes(-1, -2)).swapaxes(-1, -2)
    return ll


# ---------------------------------------------------------------------------
# EBCOT Tier-1 coefficient coding (Annex D). One engine drives both encode
# and decode through a `side` object, so the context-model control flow is
# identical by construction; only the bit source/sink differs.
# ---------------------------------------------------------------------------


class _EncSide:
    def __init__(self):
        self.mq = MQEncoder()

    def bit(self, ctx: int, actual: int) -> int:
        self.mq.encode(ctx, actual)
        return actual

    def finish(self) -> bytes:
        return self.mq.flush()


class _DecSide:
    def __init__(self, data: bytes):
        self.mq = MQDecoder(data)

    def bit(self, ctx: int, actual_unused: int) -> int:
        return self.mq.decode(ctx)


def _sig_ctx(sig, x: int, y: int, band: str) -> int:
    """Significance-coding context (Table D.1); (x, y) are bordered coords."""
    h = int(sig[y, x - 1]) + int(sig[y, x + 1])
    v = int(sig[y - 1, x]) + int(sig[y + 1, x])
    d = (int(sig[y - 1, x - 1]) + int(sig[y - 1, x + 1])
         + int(sig[y + 1, x - 1]) + int(sig[y + 1, x + 1]))
    if band == "HL":  # horizontally high-pass: roles of h and v swap
        h, v = v, h
    if band != "HH":
        if h == 2:
            return 8
        if h == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else (1 if hv == 1 else 0)


def _sign_ctx(sgn, x: int, y: int) -> tuple[int, int]:
    """Sign-coding (context, xor-bit) per Tables D.2/D.3; sgn holds +1/-1
    where significant, 0 elsewhere."""
    h = max(-1, min(1, int(sgn[y, x - 1]) + int(sgn[y, x + 1])))
    v = max(-1, min(1, int(sgn[y - 1, x]) + int(sgn[y + 1, x])))
    if h == 1:
        return (13, 0) if v == 1 else ((12, 0) if v == 0 else (11, 0))
    if h == 0:
        return (10, 0) if v == 1 else ((9, 0) if v == 0 else (10, 1))
    return (11, 1) if v == 1 else ((12, 1) if v == 0 else (13, 1))


def _t1_run_passes(side, mag, sgn_bits, w: int, h: int, band: str,
                   msb: int, numpasses: int, lastp=None) -> None:
    """Run `numpasses` coding passes starting at bitplane `msb`.

    mag: (h, w) int64 — encoder: true magnitudes (read); decoder: zeros
    (built up). sgn_bits: (h, w) uint8 sign bits, same convention.
    lastp: optional (h, w) int64 — decoder side, records the bitplane of
    each coefficient's last decoded magnitude bit (significance or
    refinement); the remaining uncertainty interval is 2^lastp wide, which
    drives the midpoint reconstruction of quantized (9/7) streams.
    """
    sig = np.zeros((h + 2, w + 2), np.uint8)
    sgn = np.zeros((h + 2, w + 2), np.int8)
    refined = np.zeros((h, w), bool)
    visited = np.zeros((h, w), bool)
    track = lastp is not None

    def code_sign(x: int, y: int) -> None:
        ctx, xorbit = _sign_ctx(sgn, x + 1, y + 1)
        sbit = side.bit(ctx, int(sgn_bits[y, x]) ^ xorbit) ^ xorbit
        sgn_bits[y, x] = sbit
        sig[y + 1, x + 1] = 1
        sgn[y + 1, x + 1] = -1 if sbit else 1

    def pass_spp(p: int) -> None:
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y + 1, x + 1]:
                        continue
                    ctx = _sig_ctx(sig, x + 1, y + 1, band)
                    if ctx == 0:  # no significant neighbor: not in this pass
                        continue
                    visited[y, x] = True
                    if side.bit(ctx, (int(mag[y, x]) >> p) & 1):
                        mag[y, x] |= 1 << p
                        code_sign(x, y)
                        if track:
                            lastp[y, x] = p

    def pass_mrp(p: int) -> None:
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if not sig[y + 1, x + 1] or visited[y, x]:
                        continue
                    if refined[y, x]:
                        ctx = 16
                    else:
                        xb, yb = x + 1, y + 1
                        any_nb = (sig[yb - 1 : yb + 2, xb - 1 : xb + 2].sum()
                                  - sig[yb, xb]) > 0
                        ctx = 15 if any_nb else 14
                    bit = side.bit(ctx, (int(mag[y, x]) >> p) & 1)
                    if bit:
                        mag[y, x] |= 1 << p
                    else:
                        mag[y, x] &= ~(1 << p)
                    refined[y, x] = True
                    if track:
                        lastp[y, x] = p

    def pass_cleanup(p: int) -> None:
        for y0 in range(0, h, 4):
            full = y0 + 4 <= h
            for x in range(w):
                start = 0
                if full:
                    rl = all(
                        not sig[y0 + dy + 1, x + 1]
                        and not visited[y0 + dy, x]
                        and _sig_ctx(sig, x + 1, y0 + dy + 1, band) == 0
                        for dy in range(4)
                    )
                    if rl:
                        actual_any = any((int(mag[y0 + dy, x]) >> p) & 1
                                         for dy in range(4))
                        if not side.bit(CTX_RL, int(actual_any)):
                            continue  # whole column stays insignificant
                        r_act = next(
                            (dy for dy in range(4)
                             if (int(mag[y0 + dy, x]) >> p) & 1), 0)
                        r = (side.bit(CTX_UNI, (r_act >> 1) & 1) << 1)
                        r |= side.bit(CTX_UNI, r_act & 1)
                        y = y0 + r
                        mag[y, x] |= 1 << p
                        code_sign(x, y)
                        if track:
                            lastp[y, x] = p
                        start = r + 1
                for dy in range(start, 4 if full else h - y0):
                    y = y0 + dy
                    if sig[y + 1, x + 1] or visited[y, x]:
                        continue
                    ctx = _sig_ctx(sig, x + 1, y + 1, band)
                    if side.bit(ctx, (int(mag[y, x]) >> p) & 1):
                        mag[y, x] |= 1 << p
                        code_sign(x, y)
                        if track:
                            lastp[y, x] = p

    passno = 0
    p = msb
    while passno < numpasses:
        if passno == 0:
            pass_cleanup(p)
            passno += 1
        else:
            pass_spp(p)
            passno += 1
            if passno >= numpasses:
                break
            pass_mrp(p)
            passno += 1
            if passno >= numpasses:
                break
            pass_cleanup(p)
            passno += 1
        visited[:, :] = False
        p -= 1
        if p < 0:
            break


def t1_encode_block(mag: np.ndarray, sgn_bits: np.ndarray, band: str,
                    mb: int) -> tuple[int, int, bytes]:
    """-> (zero_bitplanes, numpasses, codeword segment). mag all-zero blocks
    must be excluded by the caller (packet inclusion coding)."""
    h, w = mag.shape
    msb = int(mag.max()).bit_length() - 1
    zbp = mb - 1 - msb
    if zbp < 0:
        raise ValueError(f"block magnitudes exceed Mb={mb} bitplanes")
    numpasses = 3 * (msb + 1) - 2
    side = _EncSide()
    _t1_run_passes(side, mag.astype(np.int64).copy(), sgn_bits.copy(),
                   w, h, band, msb, numpasses)
    return zbp, numpasses, side.finish()


def t1_decode_block(data: bytes, w: int, h: int, band: str, mb: int,
                    zbp: int, numpasses: int, want_lastp: bool = False):
    """-> (h, w) int64 signed coefficients; with want_lastp, a second
    (h, w) int64 array of each coefficient's last-decoded bitplane."""
    mag = np.zeros((h, w), np.int64)
    sgn_bits = np.zeros((h, w), np.uint8)
    lastp = np.zeros((h, w), np.int64) if want_lastp else None
    msb = mb - 1 - zbp
    if msb < 0:
        raise ValueError("zero-bitplane count exceeds Mb")
    side = _DecSide(data)
    _t1_run_passes(side, mag, sgn_bits, w, h, band, msb, numpasses, lastp)
    signed = np.where(sgn_bits > 0, -mag, mag)
    return (signed, lastp) if want_lastp else signed


# ---------------------------------------------------------------------------
# Packet-header bit IO (B.10.1): MSB-first with 0xFF stuffing — a byte
# following 0xFF carries 7 bits. Headers are byte-aligned at the end; a
# terminal 0xFF is followed by one stuffed pad byte.
# ---------------------------------------------------------------------------


class _HdrReader:
    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.cur = 0
        self.ct = 0
        self.prev = 0

    def _byte_in(self) -> None:
        if self.pos >= len(self.buf):
            raise ValueError("JPEG 2000 packet header truncated")
        self.cur = self.buf[self.pos]
        self.pos += 1
        self.ct = 7 if self.prev == 0xFF else 8
        self.prev = self.cur

    def read_bit(self) -> int:
        if self.ct == 0:
            self._byte_in()
        self.ct -= 1
        return (self.cur >> self.ct) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align(self) -> None:
        self.ct = 0
        if self.prev == 0xFF:  # consume the stuffed pad byte
            self._byte_in()
            self.ct = 0
        self.prev = 0


class _HdrWriter:
    def __init__(self):
        self.out = bytearray()
        self.cap = 8
        self.used = 0
        self.cur = 0

    def write_bit(self, b: int) -> None:
        self.cur = (self.cur << 1) | (b & 1)
        self.used += 1
        if self.used == self.cap:
            self._emit()

    def _emit(self) -> None:
        self.out.append(self.cur)
        self.cap = 7 if self.cur == 0xFF else 8
        self.cur = 0
        self.used = 0

    def append(self, b: int) -> None:  # TagTree.encode sink protocol
        self.write_bit(b)

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def finish(self) -> bytes:
        if self.used:
            self.cur <<= self.cap - self.used
            self._emit()
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0x00)
        return bytes(self.out)


def _read_numpasses(r: _HdrReader) -> int:
    """B.10.6 codeword for the number of coding passes."""
    if not r.read_bit():
        return 1
    if not r.read_bit():
        return 2
    t = r.read_bits(2)
    if t != 3:
        return 3 + t
    t = r.read_bits(5)
    if t != 31:
        return 6 + t
    return 37 + r.read_bits(7)


def _write_numpasses(w: _HdrWriter, n: int) -> None:
    if n == 1:
        w.write_bit(0)
    elif n == 2:
        w.write_bits(0b10, 2)
    elif n <= 5:
        w.write_bits(0b11, 2)
        w.write_bits(n - 3, 2)
    elif n <= 36:
        w.write_bits(0b1111, 4)
        w.write_bits(n - 6, 5)
    elif n <= 164:
        w.write_bits(0b111111111, 9)
        w.write_bits(n - 37, 7)
    else:
        raise ValueError(f"cannot signal {n} coding passes")


# ---------------------------------------------------------------------------
# Subband / code-block geometry (zero offsets, one tile, one precinct).
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _band_layout(w: int, h: int, levels: int):
    """Per resolution r = 0..levels, the list of (name, bw, bh, gain)."""
    dims = [(w, h)]
    for _ in range(levels):
        pw, ph = dims[-1]
        dims.append((_ceil_div(pw, 2), _ceil_div(ph, 2)))
    # dims[j] = size of LL_j; resolution r uses level l = levels - r + 1
    out = [[("LL", dims[levels][0], dims[levels][1], 0)]]
    for r in range(1, levels + 1):
        lvl = levels - r + 1
        pw, ph = dims[lvl - 1]
        lw, lh = _ceil_div(pw, 2), _ceil_div(ph, 2)
        hw, hh = pw - lw, ph - lh  # floor halves
        out.append([("HL", hw, lh, 1), ("LH", lw, hh, 1), ("HH", hw, hh, 2)])
    return out


class _Block:
    __slots__ = ("x0", "y0", "w", "h", "included", "zbp", "lblock",
                 "numpasses", "data", "pending")

    def __init__(self, x0, y0, w, h):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h
        self.included = False
        self.zbp = 0
        self.lblock = 3
        self.numpasses = 0
        self.data = bytearray()
        self.pending = None


class _Band:
    def __init__(self, name: str, bw: int, bh: int, gain: int,
                 cbw: int, cbh: int):
        self.name, self.w, self.h, self.gain = name, bw, bh, gain
        self.nbx = _ceil_div(bw, cbw) if bw else 0
        self.nby = _ceil_div(bh, cbh) if bh else 0
        self.blocks = [
            [_Block(bx * cbw, by * cbh,
                    min(cbw, bw - bx * cbw), min(cbh, bh - by * cbh))
             for bx in range(self.nbx)]
            for by in range(self.nby)
        ]
        if self.nbx and self.nby:
            self.incl_tree = TagTree(self.nbx, self.nby)
            self.zbp_tree = TagTree(self.nbx, self.nby)
        self.coeffs = np.zeros((bh, bw), np.int64)


# ---------------------------------------------------------------------------
# Packet parse / emit (B.10). Single component + single precinct per
# resolution, so a packet is identified by (layer, resolution).
# ---------------------------------------------------------------------------


def _parse_packet(buf: bytes, pos: int, bands, layer: int,
                  use_sop: bool, use_eph: bool) -> int:
    if use_sop and buf[pos : pos + 2] == b"\xff\x91":
        pos += 6  # SOP marker segment: FF91 Lsop=0004 Nsop(2)
    r = _HdrReader(buf, pos)
    contributions = []
    if r.read_bit():  # non-empty packet
        for band in bands:
            if band.nbx == 0 or band.nby == 0:
                continue
            for by in range(band.nby):
                for bx in range(band.nbx):
                    blk = band.blocks[by][bx]
                    if blk.included:
                        incl = r.read_bit()
                    else:
                        incl = band.incl_tree.decode(r, bx, by, layer + 1)
                    if not incl:
                        continue
                    if not blk.included:
                        t = 1
                        while not band.zbp_tree.decode(r, bx, by, t):
                            t += 1
                        blk.zbp = band.zbp_tree.leaf_value(bx, by)
                        blk.lblock = 3
                        blk.included = True
                    npasses = _read_numpasses(r)
                    while r.read_bit():
                        blk.lblock += 1
                    nbits = blk.lblock + (npasses.bit_length() - 1)
                    length = r.read_bits(nbits)
                    blk.numpasses += npasses
                    contributions.append((blk, length))
    r.align()
    pos = r.pos
    if use_eph:
        if buf[pos : pos + 2] != b"\xff\x92":
            raise ValueError("expected EPH marker after packet header")
        pos += 2
    for blk, length in contributions:
        blk.data += buf[pos : pos + length]
        if pos + length > len(buf):
            raise ValueError("JPEG 2000 packet body truncated")
        pos += length
    return pos


def _layer_contrib(blk, layer: int):
    """This layer's (npasses, bytes) contribution of an encoder block.
    blk.pending is (zbp, [per-layer contribution or None])."""
    if blk.pending is None:
        return None
    return blk.pending[1][layer]


def _emit_packet(bands, layer: int) -> bytes:
    """Encode one packet: this layer's contributions of one resolution."""
    w = _HdrWriter()
    entries = []
    any_included = any(
        _layer_contrib(blk, layer) is not None
        for band in bands if band.nbx and band.nby
        for row in band.blocks for blk in row
    )
    if not any_included:
        w.write_bit(0)
        return w.finish()
    w.write_bit(1)
    for band in bands:
        if band.nbx == 0 or band.nby == 0:
            continue
        for by in range(band.nby):
            for bx in range(band.nbx):
                blk = band.blocks[by][bx]
                contrib = _layer_contrib(blk, layer)
                if blk.included:
                    w.write_bit(1 if contrib else 0)
                else:
                    band.incl_tree.encode(w, bx, by, layer + 1)
                if contrib is None:
                    continue
                npasses, data = contrib
                if not blk.included:
                    band.zbp_tree.encode(w, bx, by, blk.pending[0] + 1)
                    blk.lblock = 3
                    blk.included = True
                _write_numpasses(w, npasses)
                nbits_needed = max(1, len(data)).bit_length()
                base = npasses.bit_length() - 1
                while blk.lblock + base < nbits_needed:
                    w.write_bit(1)
                    blk.lblock += 1
                w.write_bit(0)
                w.write_bits(len(data), blk.lblock + base)
                entries.append(data)
    out = bytearray(w.finish())
    for data in entries:
        out += data
    return bytes(out)


def _split_passes(npasses: int, data: bytes, layers: int):
    """Distribute a block's passes and (arbitrarily splittable, since style-0
    segments are only ever concatenated back) bytes across quality layers."""
    per = [npasses // layers + (1 if i < npasses % layers else 0)
           for i in range(layers)]
    out = []
    off = 0
    done = 0
    for np_l in per:
        if np_l == 0:
            out.append(None)
            continue
        done += np_l
        end = len(data) if done == npasses else max(
            off, len(data) * done // npasses)
        out.append((np_l, data[off:end]))
        off = end
    return out


# ---------------------------------------------------------------------------
# Codestream markers
# ---------------------------------------------------------------------------


def _u16(b, i):
    return (b[i] << 8) | b[i + 1]


def _u32(b, i):
    return int.from_bytes(b[i : i + 4], "big")


def _seg(marker: int, body: bytes) -> bytes:
    return marker.to_bytes(2, "big") + (len(body) + 2).to_bytes(2, "big") + body


class _CodingParams:
    """Parsed SIZ/COD/QCD state for the single tile-component."""

    w = h = 0
    depth = 0
    signed = False
    levels = 5
    xcb = ycb = 6
    layers = 1
    prog = 0
    use_sop = use_eph = False
    guard = 2
    reversible = True
    qstyle = 0  # 0 = none, 1 = scalar derived, 2 = scalar expounded
    quant: list | None = None  # [(eps, mu), ...] per subband (style 0: mu=0)


def _parse_main_header(buf: bytes, pos: int) -> tuple[_CodingParams, int]:
    if _u16(buf, pos) != SOC:
        raise ValueError("not a JPEG 2000 codestream (missing SOC)")
    pos += 2
    cp = _CodingParams()
    seen = set()
    while True:
        if pos + 4 > len(buf):
            raise ValueError("JPEG 2000 main header truncated")
        marker = _u16(buf, pos)
        if marker == SOT:
            break
        seglen = _u16(buf, pos + 2)
        body = buf[pos + 4 : pos + 2 + seglen]
        if marker == SIZ:
            cp.w = _u32(body, 2)
            cp.h = _u32(body, 6)
            xo, yo = _u32(body, 10), _u32(body, 14)
            xt, yt = _u32(body, 18), _u32(body, 22)
            xto, yto = _u32(body, 26), _u32(body, 30)
            ncomp = _u16(body, 34)
            if ncomp != 1:
                raise ValueError(
                    f"JPEG 2000 with {ncomp} components unsupported "
                    "(DICOM grayscale expected)"
                )
            if xo or yo or xto or yto:
                raise ValueError("JPEG 2000 nonzero image/tile offsets "
                                 "unsupported")
            if xt < cp.w or yt < cp.h:
                raise ValueError("multi-tile JPEG 2000 unsupported")
            ssiz = body[36]
            cp.depth = (ssiz & 0x7F) + 1
            cp.signed = bool(ssiz & 0x80)
            if body[37] != 1 or body[38] != 1:
                raise ValueError("JPEG 2000 subsampled components unsupported")
        elif marker == COD:
            scod = body[0]
            cp.use_sop = bool(scod & 2)
            cp.use_eph = bool(scod & 4)
            cp.prog = body[1]
            cp.layers = _u16(body, 2)
            if body[4] != 0:
                raise ValueError("JPEG 2000 multi-component transform "
                                 "unsupported for 1 component")
            cp.levels = body[5]
            cp.xcb = (body[6] & 0x0F) + 2
            cp.ycb = (body[7] & 0x0F) + 2
            if body[8] != 0:
                raise ValueError(
                    "JPEG 2000 code-block style 0x%02x unsupported (bypass/"
                    "reset/termination/causal/segmentation)" % body[8]
                )
            if body[9] == 1:
                cp.reversible = True
            elif body[9] == 0:
                cp.reversible = False  # irreversible 9/7 (lossy)
            else:
                raise ValueError(
                    f"JPEG 2000 transform type {body[9]} unknown")
            if scod & 1:  # explicit precincts: accept only whole-resolution
                sizes = body[10:]
                if len(sizes) < cp.levels + 1:
                    raise ValueError("COD precinct sizes truncated")
                for r in range(cp.levels + 1):
                    ppx = sizes[r] & 0x0F
                    ppy = sizes[r] >> 4
                    rw = _ceil_div(cp.w, 1 << (cp.levels - r))
                    rh = _ceil_div(cp.h, 1 << (cp.levels - r))
                    if (1 << ppx) < rw or (1 << ppy) < rh:
                        raise ValueError(
                            "JPEG 2000 multi-precinct streams unsupported"
                        )
        elif marker == QCD:
            sqcd = body[0]
            style = sqcd & 0x1F
            cp.guard = sqcd >> 5
            cp.qstyle = style
            if style == 0:  # no quantization: one exponent byte per subband
                cp.quant = [(b >> 3, 0) for b in body[1:]]
            elif style in (1, 2):  # scalar derived / expounded: 16-bit each
                if (len(body) - 1) % 2:
                    raise ValueError("QCD scalar entries truncated")
                cp.quant = [
                    (_u16(body, 1 + 2 * i) >> 11,
                     _u16(body, 1 + 2 * i) & 0x7FF)
                    for i in range((len(body) - 1) // 2)
                ]
                if not cp.quant:
                    raise ValueError("QCD has no quantization entries")
            else:
                raise ValueError(f"JPEG 2000 QCD style {style} unknown")
        elif marker in (COC, QCC, POC, RGN, PPM):
            raise ValueError(
                f"JPEG 2000 marker 0x{marker:04X} unsupported "
                "(per-component overrides / progressions / packed headers)"
            )
        elif marker in (COM, CRG, TLM, PLM):
            pass
        else:
            raise ValueError(f"unexpected JPEG 2000 marker 0x{marker:04X}")
        pos += 2 + seglen
        seen.add(marker)
    if SIZ not in seen or COD not in seen or QCD not in seen:
        raise ValueError("JPEG 2000 main header missing SIZ/COD/QCD")
    if cp.reversible != (cp.qstyle == 0):
        # T.800 pairs 5/3 with no-quantization and 9/7 with scalar (E.1)
        raise ValueError(
            "JPEG 2000 transform/quantization mismatch (5/3 requires QCD "
            "style 0, 9/7 requires scalar quantization)"
        )
    return cp, pos


def _collect_tile_data(buf: bytes, pos: int) -> bytes:
    """Concatenate the bitstreams of all tile-parts of tile 0."""
    chunks = []
    while pos + 4 <= len(buf) and _u16(buf, pos) == SOT:
        if _u16(buf, pos + 2) != 10:
            raise ValueError("malformed SOT segment")
        isot = _u16(buf, pos + 4)
        psot = _u32(buf, pos + 6)
        if isot != 0:
            raise ValueError("multi-tile JPEG 2000 unsupported")
        end = pos + psot if psot else len(buf) - 2  # 0: runs to EOC
        p = pos + 12
        while _u16(buf, p) != SOD:
            marker = _u16(buf, p)
            if marker in (COM, PLT):
                p += 2 + _u16(buf, p + 2)
            else:
                raise ValueError(
                    f"JPEG 2000 tile-part marker 0x{marker:04X} unsupported"
                )
        chunks.append(buf[p + 2 : end])
        pos = end
    if not chunks:
        raise ValueError("JPEG 2000 codestream has no tile-part")
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


def _strip_jp2(buf: bytes) -> bytes:
    """Extract the raw codestream from a JP2 container if present."""
    if not buf.startswith(_JP2_SIGNATURE):
        return buf
    pos = 0
    while pos + 8 <= len(buf):
        ln = _u32(buf, pos)
        btype = buf[pos + 4 : pos + 8]
        if ln == 1:  # extended 64-bit length
            ln = int.from_bytes(buf[pos + 8 : pos + 16], "big")
            payload = pos + 16
        else:
            payload = pos + 8
        if ln == 0:  # box runs to end of file
            ln = len(buf) - pos
        if btype == b"jp2c":
            return buf[payload : pos + ln]
        pos += ln
    raise ValueError("JP2 container has no codestream (jp2c) box")


def _band_quant(cp: _CodingParams, r: int, bi: int) -> tuple[int, int]:
    """(exponent, mantissa) for resolution r, band index bi within it."""
    quant = cp.quant
    if cp.qstyle == 1:
        # scalar derived (E-5): one (eps0, mu0) for the N_L-level LL;
        # a band produced at decomposition level `lev` uses
        # eps = eps0 - N_L + lev (finer bands -> smaller eps -> larger step)
        eps0, mu0 = quant[0]
        lev = cp.levels if r == 0 else cp.levels - r + 1
        return eps0 - cp.levels + lev, mu0
    if len(quant) == 1:  # degenerate style-0 single entry: replicate
        return quant[0]
    idx = 0 if r == 0 else 3 * (r - 1) + 1 + bi
    if idx >= len(quant):
        raise ValueError("QCD has too few subband entries")
    return quant[idx]


@corrupt_stream_guard
def decode_j2k(buf: bytes) -> np.ndarray:
    """Decode a JPEG 2000 codestream (or JP2 file) -> (rows, cols) int64
    sample values (negative iff the stream is signed). Reversible (5/3)
    streams decode exactly; irreversible (9/7, scalar-quantized) streams
    decode with midpoint reconstruction like OpenJPEG/GDCM."""
    buf = _strip_jp2(bytes(buf))
    try:
        cp, pos = _parse_main_header(buf, 0)
        tile = _collect_tile_data(buf, pos)
    except IndexError as e:  # truncated codestream: headers run off the end
        raise ValueError("truncated JPEG 2000 codestream") from e

    layout = _band_layout(cp.w, cp.h, cp.levels)
    cbw, cbh = 1 << cp.xcb, 1 << cp.ycb
    bands_per_res = [
        [_Band(name, bw, bh, gain, cbw, cbh) for name, bw, bh, gain in row]
        for row in layout
    ]

    # packet order: single component + single precinct means every
    # progression is a nesting of layers and resolutions
    if cp.prog == 0:  # LRCP
        order = [(l, r) for l in range(cp.layers)
                 for r in range(cp.levels + 1)]
    else:  # RLCP / RPCL / PCRL / CPRL all reduce to resolution-major
        order = [(l, r) for r in range(cp.levels + 1)
                 for l in range(cp.layers)]
    p = 0
    for layer, r in order:
        p = _parse_packet(tile, p, bands_per_res[r], layer,
                          cp.use_sop, cp.use_eph)

    fcoeffs = None
    if not cp.reversible:
        fcoeffs = [
            [np.zeros((band.h, band.w), np.float64) for band in bands]
            for bands in bands_per_res
        ]
    for r, bands in enumerate(bands_per_res):
        for bi, band in enumerate(bands):
            eps, mu = _band_quant(cp, r, bi)
            mb = cp.guard + eps - 1
            if not cp.reversible:
                # Delta_b = 2^(R_b - eps) * (1 + mu/2^11), R_b = depth + gain
                delta = 2.0 ** (cp.depth + band.gain - eps) * (1 + mu / 2048)
            for row in band.blocks:
                for blk in row:
                    if not blk.included or blk.numpasses == 0:
                        continue
                    if cp.reversible:
                        coeff = t1_decode_block(
                            bytes(blk.data), blk.w, blk.h, band.name, mb,
                            blk.zbp, blk.numpasses)
                        band.coeffs[blk.y0 : blk.y0 + blk.h,
                                    blk.x0 : blk.x0 + blk.w] = coeff
                    else:
                        coeff, lastp = t1_decode_block(
                            bytes(blk.data), blk.w, blk.h, band.name, mb,
                            blk.zbp, blk.numpasses, want_lastp=True)
                        # midpoint of the remaining uncertainty interval:
                        # |q| known down to bitplane lastp -> + 2^lastp / 2
                        mag = np.abs(coeff).astype(np.float64)
                        mag += np.where(mag > 0, 0.5 * 2.0 ** lastp, 0.0)
                        fcoeffs[r][bi][blk.y0 : blk.y0 + blk.h,
                                       blk.x0 : blk.x0 + blk.w] = (
                            np.sign(coeff) * mag * delta)

    if cp.reversible:
        ll = bands_per_res[0][0].coeffs
        hi = [tuple(b.coeffs for b in bands_per_res[r])
              for r in range(1, cp.levels + 1)]
        img = dwt53_inverse(ll, hi)
    else:
        ll = fcoeffs[0][0]
        hi = [tuple(fcoeffs[r]) for r in range(1, cp.levels + 1)]
        img = np.rint(dwt97_inverse(ll, hi)).astype(np.int64)
    if cp.signed:
        lo, hic = -(1 << (cp.depth - 1)), (1 << (cp.depth - 1)) - 1
    else:
        img = img + (1 << (cp.depth - 1))  # undo DC level shift (E.1.1)
        lo, hic = 0, (1 << cp.depth) - 1
    return np.clip(img, lo, hic)


def encode_j2k(img: np.ndarray, depth: int = 16, signed: bool = False,
               levels: int | None = None, cblk: int = 64,
               layers: int = 1, irreversible: bool = False,
               qdrop: int = 0, derived: bool = False) -> bytes:
    """Encode (rows, cols) integer samples as an LRCP JPEG 2000 codestream
    (for tests/fixtures; see module docstring). layers > 1 splits each
    block's coding passes across quality layers — with style-0
    (non-terminated) segments the byte split is arbitrary, so this
    exercises a decoder's multi-layer accumulation path exactly as a
    rate-allocating encoder would.

    irreversible=True uses the 9/7 wavelet with scalar quantization:
    expounded (QCD style 2) by default, derived (style 1) with
    derived=True. qdrop coarsens every step size by 2^qdrop — qdrop=0 is
    near-lossless (step 1.0 absorbs only the float->int rounding)."""
    img = np.asarray(img, np.int64)
    h, w = img.shape
    if signed:
        lo, hi = -(1 << (depth - 1)), (1 << (depth - 1)) - 1
    else:
        lo, hi = 0, (1 << depth) - 1
    if img.min() < lo or img.max() > hi:
        raise ValueError(f"samples outside [{lo}, {hi}] for depth {depth}")
    if levels is None:
        levels = max(0, min(5, min(w, h).bit_length() - 1))
    xcb = ycb = max(2, min(10, int(np.log2(cblk))))
    if xcb + ycb > 12:  # T.800 limits code-block area to 4096 samples
        xcb = ycb = 6
    cbw, cbh = 1 << xcb, 1 << ycb

    layout = _band_layout(w, h, levels)
    guard = 2
    shifted = img if signed else img - (1 << (depth - 1))

    def band_lev(r: int) -> int:  # decomposition level that produced res r
        return levels if r == 0 else levels - r + 1

    def band_eps(r: int, gain: int) -> int:
        if not irreversible:
            return depth + gain
        if derived:  # E-5: eps = eps0 - N_L + lev, eps0 covers the LL
            return (depth - qdrop) - levels + band_lev(r)
        return depth + gain - qdrop

    if irreversible:
        ll, hi_bands = dwt97_forward(shifted, levels)
        # quantize: q = sign(c) * floor(|c| / Delta_b), Delta = 2^(R-eps)
        quantized = []
        for r, row in enumerate(layout):
            qrow = []
            for bi, (name, bw, bh, gain) in enumerate(row):
                c = ll if r == 0 else hi_bands[r - 1][bi]
                delta = 2.0 ** (depth + gain - band_eps(r, gain))
                qrow.append((np.sign(c)
                             * np.floor(np.abs(c) / delta)).astype(np.int64))
            quantized.append(qrow)
        all_coeffs = quantized
    else:
        ll, hi_bands = dwt53_forward(shifted, levels)
        all_coeffs = [[ll]] + [list(t) for t in hi_bands]

    bands_per_res = []
    for r, row in enumerate(layout):
        bands = []
        for bi, (name, bw, bh, gain) in enumerate(row):
            band = _Band(name, bw, bh, gain, cbw, cbh)
            band.coeffs = np.asarray(all_coeffs[r][bi], np.int64)
            assert band.coeffs.shape == (bh, bw), (
                name, band.coeffs.shape, (bh, bw))
            bands.append(band)
        bands_per_res.append(bands)

    # T1-encode every code block; mark all-zero blocks excluded
    for r, bands in enumerate(bands_per_res):
        for bi, band in enumerate(bands):
            if band.nbx == 0 or band.nby == 0:
                continue
            mb = guard + band_eps(r, band.gain) - 1
            incl = np.full((band.nby, band.nbx), layers,
                           np.int64)  # layers = never included
            zbps = np.zeros((band.nby, band.nbx), np.int64)
            for by, row_b in enumerate(band.blocks):
                for bx, blk in enumerate(row_b):
                    mag = np.abs(band.coeffs[blk.y0 : blk.y0 + blk.h,
                                             blk.x0 : blk.x0 + blk.w])
                    if not mag.any():
                        continue
                    sgn = (band.coeffs[blk.y0 : blk.y0 + blk.h,
                                       blk.x0 : blk.x0 + blk.w] < 0
                           ).astype(np.uint8)
                    zbp, npasses, data = t1_encode_block(
                        mag, sgn, band.name, mb)
                    blk.pending = (zbp, _split_passes(npasses, data, layers))
                    incl[by, bx] = 0
                    zbps[by, bx] = zbp
            band.incl_tree.set_values(incl)
            band.zbp_tree.set_values(zbps)

    tile = b"".join(_emit_packet(bands_per_res[r], l)
                    for l in range(layers)
                    for r in range(levels + 1))

    siz = (b"\x00\x00" + w.to_bytes(4, "big") + h.to_bytes(4, "big")
           + bytes(8) + w.to_bytes(4, "big") + h.to_bytes(4, "big")
           + bytes(8) + b"\x00\x01"
           + bytes(((depth - 1) | (0x80 if signed else 0), 1, 1)))
    cod = bytes((0, 0)) + layers.to_bytes(2, "big") + bytes(
        (0, levels, xcb - 2, ycb - 2, 0, 0 if irreversible else 1))
    nsub = 1 + 3 * levels
    if not irreversible:
        exps = []
        for r, row in enumerate(layout):
            for name, bw, bh, gain in row:
                exps.append(depth + gain)
        qcd = bytes((guard << 5,)) + bytes(e << 3 for e in exps[:nsub])
    elif derived:
        qcd = bytes((1 | (guard << 5),)) + (
            (depth - qdrop) << 11).to_bytes(2, "big")
    else:
        words = []
        for r, row in enumerate(layout):
            for name, bw, bh, gain in row:
                words.append(band_eps(r, gain) << 11)
        qcd = bytes((2 | (guard << 5),)) + b"".join(
            wd.to_bytes(2, "big") for wd in words[:nsub])
    sot_body_len = 12 + 2 + len(tile)  # SOT seg + SOD marker + data
    sot = (SOT.to_bytes(2, "big") + (10).to_bytes(2, "big")
           + (0).to_bytes(2, "big") + sot_body_len.to_bytes(4, "big")
           + bytes((0, 1)))
    return (SOC.to_bytes(2, "big") + _seg(SIZ, siz) + _seg(COD, cod)
            + _seg(QCD, qcd) + sot + SOD.to_bytes(2, "big") + tile
            + EOC.to_bytes(2, "big"))
