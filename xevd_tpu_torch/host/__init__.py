"""xevd_tpu_torch.host -- the decoder's host half (bitstream, entropy
decode, derive, DPB, `Decoder`, the numpy oracle backend), a copy of the
JAX-free modules of `xevd_tpu` that the port runs on.

Every module here is a copy of `xevd_tpu/<same path>`; a copy differs from
its original only in its module docstring and in the lines that docstring
lists (tests/test_torch_host_copy.py holds them to that).  Nothing here
imports JAX or `xevd_tpu`.
"""
from .decoder import Decoder, OutFrame, Stat
from .syntax import MalformedBitstream

__version__ = "0.1.0"

NAL_UNIT_LENGTH_BYTE = 4


def info(buf: bytes):
    """Probe a length-prefixed NALU chunk (ref: src_base/xevd_util.c:1693).

    Returns (nalu_len, nalu_type, temporal_id)."""
    if len(buf) < 4:
        return -1, -1, -1
    nalu_len = int.from_bytes(buf[:4], "big")
    nalu_type = tid = -1
    if len(buf) >= 6:
        b0, b1 = buf[4], buf[5]
        nalu_type = (b0 >> 1) & 0x3F
        tid = ((b0 & 1) << 2) | ((b1 >> 6) & 3)
    return nalu_len, nalu_type, tid
