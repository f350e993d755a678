"""What decides `correct`: the program's output pictures against the
reference decoder's.

The reference is `evcbench/oracle`, a frozen copy of the numpy oracle
(plain numpy, with the C entropy engine it always used).  It imports
nothing of `jax`, `xevd_tpu` or `xevd_tpu_torch`, and takes nothing the
program made: it reads the same committed streams.  It is independent of
the program's device half (the CUDA and Triton kernels and the batched
step).  The program's host half (parse, entropy decode, derive, pack) was
copied from the same code, so against it the comparison is a regression
check: a later change of the host half that alters a picture fails, a
fault that both copies share is not seen.  No normative decoder's output
(xevd_app's) is in the repo to settle that.

The streams are fixed, so the reference's answer is too: `python -m
evcbench.make_reference` runs it over a configuration's streams and
writes, for every picture, the MD5 of its Y, U and V (uint16
little-endian samples, cropped, as the 10-bit YUV writer writes them: the
MD5s written with the streams, which it must reproduce) and the sum of
its cropped luma, to evcbench/streams/<streams>.oracle.json.  A run
compares with that file once its window has closed.

A job's output, from `decode_gops_sharded`: per batch slot, the MD5 of
each of its GOP's pictures (made by the program from the planes it brought
back from the card), and the int64 sum of every cropped luma sample of the
job, summed on the card.  Two numbers are compared, each with the limit 0
(an exact comparison): the pictures whose MD5 differs from the reference's
(a picture that is missing or extra counts), and the jobs whose luma sum
differs from the reference's sum over the job's GOPs."""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from .spec import HERE

LIMITS = {"pictures_differing": 0, "jobs_luma_sum_differing": 0}


def reference_path(config: dict) -> Path:
    return HERE / "streams" / f"{config['streams']}.oracle.json"


def load(config: dict) -> dict:
    ref = json.loads(reference_path(config).read_text())
    if len(ref["md5s"]) != len(config["gops"]):
        raise ValueError(f"{reference_path(config).name}: "
                         f"{len(ref['md5s'])} GOPs, the configuration has "
                         f"{len(config['gops'])}")
    return ref


def _nalus(data: bytes):
    from .oracle import NAL_UNIT_LENGTH_BYTE, info
    pos = 0
    while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
        n, _, _ = info(data[pos:pos + 6])
        pos += NAL_UNIT_LENGTH_BYTE
        yield data[pos:pos + n]
        pos += n


def decode(data: bytes) -> list[tuple]:
    """The reference decode of a length-prefixed NAL unit stream: per
    output picture, in output order, its cropped (y, u, v) planes as int32
    arrays (u, v None for 4:0:0) and the bit depth the decoder reports."""
    from .oracle import Decoder
    dec = Decoder()
    out = []

    def take(f):
        out.append((tuple(None if p is None else
                          np.asarray(p).astype(np.int32)
                          for p in (f.y, f.u, f.v)), f.bit_depth))
    for nalu in _nalus(data):
        if dec.decode(nalu).fnum >= 0:
            f, _ = dec.pull()
            if f is not None:
                take(f)
    while True:
        f, _ = dec.pull()
        if f is None:
            return out
        take(f)


def picture_md5(planes, bit_depth: int) -> str:
    """MD5 of the bytes the 10-bit YUV writer writes for a picture
    (evcbench/oracle/utils/yuv.py `YuvWriter`, out_bd 10)."""
    from .oracle.utils.yuv import conv_plane, plane_bytes
    m = hashlib.md5()
    for p in planes:
        if p is not None:
            m.update(plane_bytes(conv_plane(p, bit_depth, 10), 10))
    return m.hexdigest()


def luma_sum(planes) -> int:
    return int(planes[0].astype(np.int64).sum())


def lower_precision(planes, bit_depth: int):
    """The control's picture: each sample rounded to the next precision
    below the stream's, carried at its bit depth -- 10 bits to 8 (the
    reference app's 8-bit output, `(v + 2) >> 2`), 8 bits to 7."""
    shift = 2 if bit_depth > 8 else 1
    top = (1 << bit_depth) - 1
    return tuple(None if p is None else
                 np.minimum(((p + (1 << (shift - 1))) >> shift) << shift, top)
                 for p in planes)


def compare(jobs, ref: dict) -> dict:
    """The numbers compared over `jobs`, each (order, per-slot MD5 lists,
    luma sum): the pictures compared, those whose MD5 differs from the
    reference's (missing and extra ones too), and the jobs whose luma sum
    differs."""
    pictures = differing = sums = 0
    for order, md5s, luma in jobs:
        for slot, g in enumerate(order):
            want = ref["md5s"][g]
            got = md5s[slot] if slot < len(md5s) else []
            pictures += len(want)
            differing += sum(a != b for a, b in zip(got, want))
            differing += abs(len(got) - len(want))
        if luma != sum(sum(ref["luma_sums"][g]) for g in order):
            sums += 1
    return {"pictures": pictures, "pictures_differing": differing,
            "jobs_luma_sum_differing": sums}
