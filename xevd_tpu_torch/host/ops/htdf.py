"""HTDF — hadamard-domain in-loop filter (Main profile, tool_htdf).

Host-oracle implementation (ref: src_main/xevdm_recon.c:196-385).  Applied
per CU post-reconstruction, luma only, in decode order: the filter's 1-px
ring comes from already-decoded neighbor CUs in the picture when available
(else edge replication), and filtered pixels feed later intra predictions —
so HTDF lives inside the sequential decode-order pass (and inside the
device intra scan on the JAX backend).

The 2x2 sliding hadamard windows are mutually independent (each window's
accumulator contribution is complete before the raster-order normalization
reads it), so both backends compute all windows batched.
"""
from __future__ import annotations

import numpy as np

from .. import tables as T

# availability bits for the recon-time intra availability mask
# (ref: src_base/xevd_util.c:689-745); shared with derive.py
HT_LE = 1
HT_RI = 2
HT_UP = 4
HT_UP_LE = 8
HT_UP_RI = 16
HT_LO_LE = 32
HT_LO_RI = 64


def _read_table(z, tbl, thr, shift, rnd):
    """(ref: src_main/xevdm_recon.c:173-187)"""
    v = np.abs(z)
    idx = ((v + rnd) & thr) >> shift
    w0 = np.where(v < thr, tbl[idx], v)
    return np.where(z < 0, -w0, w0)


def htdf_block(rec, x, y, w, h, avail, tbl_idx, bd):
    """Filter the w x h luma block at (x, y) of `rec` in place.

    `rec` is the frame plane (no border offset); ring pixels outside the
    block come from `rec` itself gated by `avail` bits."""
    tbl = T.HTDF_TBL[tbl_idx]
    thr_log2 = int(T.HTDF_THR_LOG2[tbl_idx])
    shift = thr_log2 - 4
    rnd = (1 << shift) >> 1
    thr = (1 << thr_log2) - (1 << shift)
    maxv = (1 << bd) - 1

    blk = rec[y:y + h, x:x + w].astype(np.int32)
    e = np.empty((h + 2, w + 2), np.int32)
    e[1:h + 1, 1:w + 1] = blk
    # left / right columns (ref :312-360)
    if avail & HT_LE:
        e[1:h + 1, 0] = rec[y:y + h, x - 1]
    else:
        e[1:h + 1, 0] = blk[:, 0]
    if avail & HT_RI:
        e[1:h + 1, w + 1] = rec[y:y + h, x + w]
    else:
        e[1:h + 1, w + 1] = blk[:, w - 1]
    # top row; bottom row is ALWAYS the block's last row (:361-378)
    if avail & HT_UP:
        e[0, 1:w + 1] = rec[y - 1, x:x + w]
    else:
        e[0, 1:w + 1] = blk[0, :]
    e[h + 1, 1:w + 1] = blk[h - 1, :]
    # corners (:380-383)
    e[0, 0] = rec[y - 1, x - 1] if avail & HT_UP_LE else blk[0, 0]
    e[0, w + 1] = rec[y - 1, x + w] if avail & HT_UP_RI else blk[0, w - 1]
    e[h + 1, 0] = rec[y + h, x - 1] if avail & HT_LO_LE else blk[h - 1, 0]
    e[h + 1, w + 1] = (rec[y + h, x + w] if avail & HT_LO_RI
                       else blk[h - 1, w - 1])

    # batched 2x2 hadamard windows (ref :210-256)
    x0 = e[:-1, :-1]
    x1 = e[:-1, 1:]
    x2 = e[1:, :-1]
    x3 = e[1:, 1:]
    y0 = x0 + x2
    y1 = x1 + x3
    y2 = x0 - x2
    y3 = x1 - x3
    t0 = y0 + y1
    t1 = y0 - y1
    t2 = y2 + y3
    t3 = y2 - y3
    z1 = _read_table(t1, tbl, thr, shift, rnd)
    z2 = _read_table(t2, tbl, thr, shift, rnd)
    z3 = _read_table(t3, tbl, thr, shift, rnd)
    iy0 = t0 + z2
    iy1 = z1 + z3
    iy2 = t0 - z2
    iy3 = z1 - z3
    acc = np.zeros((h + 2, w + 2), np.int32)
    acc[:-1, :-1] += (iy0 + iy1) >> 2
    acc[:-1, 1:] += (iy0 - iy1) >> 2
    acc[1:, :-1] += (iy2 + iy3) >> 2
    acc[1:, 1:] += (iy2 - iy3) >> 2
    out = np.clip((acc + 2) >> 2, 0, maxv)
    rec[y:y + h, x:x + w] = out[1:h + 1, 1:w + 1].astype(rec.dtype)
