"""The benchmark's reference decoder: a frozen copy of the numpy oracle of
`xevd_tpu` (its JAX-free host modules and `NumpyPixelBackend`, the decoder
that made the committed oracle MD5s and was held bit-exact to the
reference decoder `xevd`), with the C sources of its entropy engine.

Every module is a copy of `xevd_tpu/<same path>` as it stood when the
benchmark was written; the copies differ only in this docstring and in
native.py's build paths (its docstring lists them).  Nothing here imports
JAX, `xevd_tpu` or `xevd_tpu_torch`, and the program never imports this:
it is the yardstick, kept apart so that a later change to the program
cannot move it.
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
