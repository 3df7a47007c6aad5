"""The port's DICOM pixel codecs (``mmnn_sts_torch/data/{dicom_rle,
jpeg_lossless,jpeg_ls,j2k_mq,jpeg2000,jpeg_baseline,codec_util}.py``) held
against the JAX package's, on the same inputs made from a seed with numpy.

* Each port encoder's bytes equal the JAX encoder's, byte for byte.
* On the bytes of either package's encoder, the port's decoder equals the
  JAX decoder bit for bit (values and dtype). Cases: RLE 8 and 16 bit (one
  and two segments; a three-segment frame raises in both), JPEG Lossless
  predictors 1-7, JPEG-LS lossless and NEAR, JPEG 2000 5/3 lossless and
  9/7 at odd sizes and signed, JPEG baseline 8 bit and extended 12 bit.
  Frames stay at 16 x 16 or smaller: the codecs are pure Python.
* Truncated and corrupt streams: a stream cut inside its header raises
  ValueError in both; for cuts and bit flips further in, both packages give
  the same outcome (the same ValueError message, or the same array).
"""

import struct

import numpy as np
import pytest

from mmnn_sts_torch.data import dicom_rle as t_rle
from mmnn_sts_torch.data import jpeg2000 as t_j2k
from mmnn_sts_torch.data import jpeg_baseline as t_jpg
from mmnn_sts_torch.data import jpeg_lossless as t_jll
from mmnn_sts_torch.data import jpeg_ls as t_jls
from mmnn_sts_tpu.data import dicom_rle as j_rle
from mmnn_sts_tpu.data import jpeg2000 as j_j2k
from mmnn_sts_tpu.data import jpeg_baseline as j_jpg
from mmnn_sts_tpu.data import jpeg_lossless as j_jll
from mmnn_sts_tpu.data import jpeg_ls as j_jls


def _image(seed, shape, bits, signed=False, smooth=True):
    """Integer samples of ``bits`` bits: a smooth ramp plus noise (so the
    predictors and wavelets see both structure and texture), or uniform
    noise."""
    rng = np.random.default_rng(seed)
    hi = (1 << bits) - 1
    if smooth:
        y, x = np.mgrid[:shape[0], :shape[1]]
        img = (hi * (0.3 + 0.4 * np.sin(x / 3.0) * np.cos(y / 4.0))
               + rng.normal(0, hi / 40, shape))
        img = np.clip(np.rint(img), 0, hi).astype(np.int64)
    else:
        img = rng.integers(0, hi + 1, shape).astype(np.int64)
    if signed:
        img = img - (1 << (bits - 1))
    return img


CASES = []
for bits, shape in ((8, (16, 16)), (16, (16, 16)), (16, (7, 13)),
                    (8, (5, 9))):
    CASES.append(pytest.param(
        "rle", dict(bits=bits), _image(bits + shape[0], shape, bits,
                                       smooth=shape[0] != 5),
        id=f"rle-{bits}bit-{shape[0]}x{shape[1]}"))
for predictor in range(1, 8):
    CASES.append(pytest.param(
        "jpeg_lossless", dict(precision=16, predictor=predictor),
        _image(20 + predictor, (12, 10), 16), id=f"jpeg_lossless-p{predictor}"))
CASES.append(pytest.param("jpeg_lossless", dict(precision=8, predictor=1),
                          _image(30, (9, 11), 8), id="jpeg_lossless-8bit"))
for near, bits, shape in ((0, 16, (16, 16)), (0, 8, (11, 13)),
                          (3, 12, (16, 14)), (1, 8, (7, 9))):
    CASES.append(pytest.param(
        "jpeg_ls", dict(precision=bits, near=near),
        _image(40 + near + bits, shape, bits),
        id=f"jpeg_ls-near{near}-{bits}bit-{shape[0]}x{shape[1]}"))
for kw, shape, signed in (
        (dict(depth=16), (13, 11), False),
        (dict(depth=12), (16, 16), False),
        (dict(depth=16, signed=True), (9, 15), True),
        (dict(depth=12, irreversible=True), (15, 13), False),
        (dict(depth=16, irreversible=True, qdrop=2), (16, 11), False),
        (dict(depth=12, irreversible=True, derived=True), (11, 11), False),
        (dict(depth=12, layers=3), (14, 12), False)):
    name = "97" if kw.get("irreversible") else "53"
    CASES.append(pytest.param(
        "j2k", kw, _image(60 + shape[0], shape, kw["depth"], signed=signed),
        id=f"j2k-{name}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
           f"-{shape[0]}x{shape[1]}"))
for bits, quant, shape in ((8, 1, (16, 16)), (8, 4, (13, 9)),
                           (12, 1, (16, 16)), (12, 2, (10, 15))):
    CASES.append(pytest.param(
        "jpeg_baseline", dict(precision=bits, quant=quant),
        _image(80 + bits + quant, shape, bits),
        id=f"jpeg_baseline-{bits}bit-q{quant}-{shape[0]}x{shape[1]}"))


def _codec(kind, kw, shape):
    """(port encode, JAX encode, port decode, JAX decode) of one case."""
    if kind == "rle":
        bits = kw["bits"]
        return (lambda img: t_rle.encode_rle_frame(img, bits),
                lambda img: j_rle.encode_rle_frame(img, bits),
                lambda b: t_rle.decode_rle_frame(b, *shape, bits),
                lambda b: j_rle.decode_rle_frame(b, *shape, bits))
    if kind == "jpeg_lossless":
        return (lambda img: t_jll.encode_jpeg_lossless_sv1(img, **kw),
                lambda img: j_jll.encode_jpeg_lossless_sv1(img, **kw),
                t_jll.decode_jpeg_lossless, j_jll.decode_jpeg_lossless)
    if kind == "jpeg_ls":
        return (lambda img: t_jls.encode_jpeg_ls(img, **kw),
                lambda img: j_jls.encode_jpeg_ls(img, **kw),
                t_jls.decode_jpeg_ls, j_jls.decode_jpeg_ls)
    if kind == "j2k":
        return (lambda img: t_j2k.encode_j2k(img, **kw),
                lambda img: j_j2k.encode_j2k(img, **kw),
                t_j2k.decode_j2k, j_j2k.decode_j2k)
    return (lambda img: t_jpg.encode_jpeg_baseline(img, **kw),
            lambda img: j_jpg.encode_jpeg_baseline(img, **kw),
            t_jpg.decode_jpeg_baseline, j_jpg.decode_jpeg_baseline)


def _pixels(img, kind, kw):
    """The samples as the encoder takes them (RLE: unsigned words)."""
    if kind == "rle":
        return img.astype(np.uint16 if kw["bits"] == 16 else np.uint8)
    return img


def _outcome(decode, blob):
    try:
        return decode(blob)
    except ValueError as e:
        return ("ValueError", str(e))


def _same(got, want):
    if isinstance(want, tuple):
        assert got == want
    else:
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,kw,img", CASES)
def test_encoders_and_decoders_match_jax(kind, kw, img):
    t_enc, j_enc, t_dec, j_dec = _codec(kind, kw, img.shape)
    pixels = _pixels(img, kind, kw)
    blob = t_enc(pixels)
    assert isinstance(blob, bytes) and blob == j_enc(pixels)
    got, want = t_dec(blob), j_dec(blob)
    _same(got, want)
    if kind in ("rle", "jpeg_lossless") or (
            kind in ("jpeg_ls", "j2k") and not kw.get("near")
            and not kw.get("irreversible")):
        # the lossless cases give the samples back
        np.testing.assert_array_equal(got.astype(np.int64), pixels)


@pytest.mark.parametrize("kind,kw,img", [
    c for c in CASES if c.id in (
        "rle-16bit-16x16", "jpeg_lossless-p1", "jpeg_lossless-p6",
        "jpeg_ls-near0-16bit-16x16", "jpeg_ls-near3-12bit-16x14",
        "j2k-53-depth16-13x11", "j2k-97-depth12-irreversibleTrue-15x13",
        "jpeg_baseline-12bit-q1-16x16")])
def test_corrupt_streams_fail_alike(kind, kw, img):
    t_enc, _, t_dec, j_dec = _codec(kind, kw, img.shape)
    blob = t_enc(_pixels(img, kind, kw))
    header_cuts = (0, 2, 11) if kind != "rle" else (0, 10, 63)
    for cut in header_cuts:
        for decode in (t_dec, j_dec):
            with pytest.raises(ValueError):
                decode(blob[:cut])
    rng = np.random.default_rng(len(blob))
    n = len(blob)
    mutated = [blob[:cut] for cut in (n // 4, n // 2, n - 1)]
    for pos, bit in zip(rng.integers(0, n, 12), rng.integers(0, 8, 12)):
        b = bytearray(blob)
        b[pos] ^= 1 << int(bit)
        mutated.append(bytes(b))
    for m in mutated:
        _same(_outcome(t_dec, m), _outcome(j_dec, m))


def test_rle_three_segments_raise_in_both():
    """A three-segment (colour) frame is refused by both decoders."""
    header = struct.pack("<16I", 3, 64, 66, 68, *([0] * 12))
    frame = header + b"\x00\x00" * 3
    for mod in (t_rle, j_rle):
        with pytest.raises(ValueError, match="3 segments"):
            mod.decode_rle_frame(frame, 1, 1, 8)
