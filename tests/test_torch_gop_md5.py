"""The GOP batch's picture digests (xevd_tpu_torch/parallel/gop.py
`_crop_md5`, `_md5s`) against the formula they replace, kept here as the
plain reference: MD5 over each cropped plane converted to uint16 LE, Y
then U then V.  The entry's cropped int16 host buffers are hashed as they
are; every other plane is converted first, and counted as copied."""
import hashlib

import numpy as np
import pytest

from xevd_tpu_torch import spans as SP
from xevd_tpu_torch.parallel import gop as TG


def _kept_md5(y, u, v, h, w):
    m = hashlib.md5()
    for p, ph, pw in ((y, h, w), (u, h >> 1, w >> 1), (v, h >> 1, w >> 1)):
        m.update(np.ascontiguousarray(
            np.asarray(p[:ph, :pw]).astype("<u2")).tobytes())
    return m.hexdigest()


def _planes(rng, shape, dtype, lo, hi):
    """(y, u, v) of random samples in [lo, hi); `shape` is luma's."""
    h, w = shape
    return tuple(rng.integers(lo, hi, s).astype(dtype)
                 for s in ((h, w), (h >> 1, w >> 1), (h >> 1, w >> 1)))


def _cropped_int16(rng):
    # the entry's host buffers: cropped, contiguous int16, negatives too
    return [[_planes(rng, (48, 80), np.int16, -1024, 1024)]], (48, 80), False


def _cropped_uint16(rng):
    return [[_planes(rng, (48, 80), np.uint16, 0, 1 << 16)]], (48, 80), False


def _padded_int16(rng):
    # the oracle's CTU-padded planes, cropped to 3 x 5 blocks of 24
    return [[_planes(rng, (128, 128), np.int16, -512, 1024)]], (72, 120), True


def _uint8(rng):
    return [[_planes(rng, (32, 64), np.uint8, 0, 256)]], (32, 64), True


def _int32(rng):
    return ([[_planes(rng, (32, 64), np.int32, -(1 << 20), 1 << 20)]],
            (32, 64), True)


def _big_endian_int16(rng):
    return ([[tuple(p.astype(">i2") for p in
                    _planes(rng, (32, 64), np.int16, -1024, 1024))]],
            (32, 64), True)


def _twenty_pictures(rng):
    # pictures of three GOPs, 7, 1 and 12, gathered in their order
    pictures = [_planes(rng, (64, 96), np.int16, -1024, 1024)
                for _ in range(20)]
    return [pictures[:7], pictures[7:8], pictures[8:]], (64, 96), False


@pytest.mark.parametrize("make", [
    _cropped_int16, _cropped_uint16, _padded_int16, _uint8, _int32,
    _big_endian_int16, _twenty_pictures], ids=lambda f: f.__name__[1:])
def test_digests_equal_the_kept_formula(make):
    rng = np.random.default_rng(22)
    gops, (h, w), copies = make(rng)
    with SP.record() as rec:
        got = TG._md5s(gops, h, w)
    assert got == [[_kept_md5(*p, h, w) for p in pictures]
                   for pictures in gops]
    n = sum(map(len, gops))
    assert len({d for digests in got for d in digests}) == n
    nbytes = n * 2 * (h * w + 2 * (h >> 1) * (w >> 1))
    assert rec.counts == {"entry.md5.bytes": nbytes,
                          "entry.md5.copied_bytes": nbytes * copies}
