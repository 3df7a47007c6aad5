"""MQ arithmetic coder (ITU-T T.800 Annex C) — the JPEG 2000 entropy coder.

Implements the spec's software-conventions decoder (C.3) and encoder (C.2)
pseudocode: 47-state probability estimation table, byte-stuffing around 0xFF,
and the FLUSH termination. The encoder exists for golden round-trip tests and
fixture generation in data/jpeg2000.py; both sides are written from the
public spec (the same coder appears in JBIG2/T.88), no OpenJPEG/Kakadu code.

Parity note: the reference decoded JPEG 2000 DICOM implicitly through
SimpleITK/GDCM+OpenJPEG (reference data/s3utils.py:244-265); this
module is part of the from-scratch replacement (see data/jpeg2000.py).

The port's own copy of the JAX package's data/j2k_mq.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

# (Qe, NMPS, NLPS, SWITCH) — T.800 Table C.2
QE_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# T.800 Table D.7 initial context states for the T1 coder: all contexts start
# at state 0 except context 0 (all-zero-neighbor significance, state 4), the
# run-length context 17 (state 3) and the UNIFORM context 18 (state 46).
N_CONTEXTS = 19
CTX_RL = 17
CTX_UNI = 18


def initial_states() -> list[list[int]]:
    """[index, mps] per context, per Table D.7."""
    st = [[0, 0] for _ in range(N_CONTEXTS)]
    st[0][0] = 4
    st[CTX_RL][0] = 3
    st[CTX_UNI][0] = 46
    return st


class MQDecoder:
    """T.800 C.3 decoder. `buf` is one codeword segment (a code-block's
    compressed bytes); reads past the end feed 1-bits per the spec."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.bp = 0
        self.ctx = initial_states()
        # INITDEC
        b = buf[0] if buf else 0xFF
        self.c = b << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self) -> None:
        buf, bp = self.buf, self.bp
        b = buf[bp] if bp < len(buf) else 0xFF
        if b == 0xFF:
            b1 = buf[bp + 1] if bp + 1 < len(buf) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = buf[self.bp] if self.bp < len(buf) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        """Decode one binary decision in context cx."""
        st = self.ctx[cx]
        qe, nmps, nlps, switch = QE_TABLE[st[0]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange (C.3.4)
            if self.a < qe:
                d = st[1]
                st[0] = nmps
            else:
                d = 1 - st[1]
                if switch:
                    st[1] = 1 - st[1]
                st[0] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return st[1]
            # MPS exchange (C.3.3)
            if self.a < qe:
                d = 1 - st[1]
                if switch:
                    st[1] = 1 - st[1]
                st[0] = nlps
            else:
                d = st[1]
                st[0] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


class MQEncoder:
    """T.800 C.2 encoder producing one codeword segment per flush."""

    def __init__(self):
        self.ctx = initial_states()
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.out = bytearray()
        self.b = -1  # index of the byte being built (-1: none yet)

    def encode(self, cx: int, d: int) -> None:
        st = self.ctx[cx]
        qe, nmps, nlps, switch = QE_TABLE[st[0]]
        if d == st[1]:  # CODEMPS
            self.a -= qe
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            st[0] = nmps
        else:  # CODELPS
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                st[1] = 1 - st[1]
            st[0] = nlps
        while True:  # RENORME
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _byteout(self) -> None:
        out = self.out
        if self.b >= 0 and out[self.b] == 0xFF:
            self._stuff()
        elif self.c < 0x8000000:
            self._nostuff()
        else:
            if self.b >= 0:
                out[self.b] += 1  # carry propagation
                if out[self.b] == 0xFF:
                    self.c &= 0x7FFFFFF
                    self._stuff()
                    return
            else:
                # carry with no byte yet cannot occur: C starts < 0x8000000
                raise AssertionError("MQ carry before first byte")
            self._nostuff()

    def _stuff(self) -> None:
        # the byte after 0xFF carries 7 data bits PLUS the carry in bit 7,
        # so it ranges 0x00-0x8F — which is why >0x8F marks a marker
        self.b = len(self.out)
        self.out.append((self.c >> 20) & 0xFF)
        self.c &= 0xFFFFF
        self.ct = 7

    def _nostuff(self) -> None:
        self.b = len(self.out)
        self.out.append((self.c >> 19) & 0xFF)
        self.c &= 0x7FFFF
        self.ct = 8

    def flush(self) -> bytes:
        """Terminate the segment (C.2.9 FLUSH) and return its bytes."""
        # SETBITS
        tempc = self.c + self.a - 1
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        # drop a trailing 0xFF (the decoder treats it as past-the-end anyway)
        while self.out and self.out[-1] == 0xFF:
            self.out.pop()
        return bytes(self.out)
