"""Host-oracle application of the ADDB deblocking filter.

Two frame passes (vertical edges, then horizontal — same driver order as
the base filter, ref: src_main/xevdm.c:3152 is_hor_edge loop).  Every ADDB
edge sits on the 8x8 luma grid and filters at most 3 px a side, so edges
within a pass are independent; this oracle still walks them cell-by-cell
for clarity.  Parameters come from derive._addb_params
(ref: src_main/xevdm_df.c:835-1135)."""
from __future__ import annotations

import numpy as np

from . import addb_common as AC


def _luma_edge_ver(plane, ys, xp_, bs, alpha, beta, c1, bd):
    """Vertical edge at luma col xp_, SCU row ys (4 lines)."""
    rows = slice(ys * 4, ys * 4 + 4)
    p = tuple(plane[rows, xp_ - 1 - k].astype(np.int32) for k in range(4))
    q = tuple(plane[rows, xp_ + k].astype(np.int32) for k in range(4))
    bsa = np.full(4, bs)
    (p0, p1, p2), (q0, q1, q2) = AC.luma_line(
        np, p, q, bsa, np.full(4, alpha), np.full(4, beta),
        np.full(4, c1), bd)
    plane[rows, xp_ - 1] = p0
    plane[rows, xp_ - 2] = p1
    plane[rows, xp_ - 3] = p2
    plane[rows, xp_] = q0
    plane[rows, xp_ + 1] = q1
    plane[rows, xp_ + 2] = q2


def _luma_edge_hor(plane, yp_, xs, bs, alpha, beta, c1, bd):
    cols = slice(xs * 4, xs * 4 + 4)
    p = tuple(plane[yp_ - 1 - k, cols].astype(np.int32) for k in range(4))
    q = tuple(plane[yp_ + k, cols].astype(np.int32) for k in range(4))
    bsa = np.full(4, bs)
    (p0, p1, p2), (q0, q1, q2) = AC.luma_line(
        np, p, q, bsa, np.full(4, alpha), np.full(4, beta),
        np.full(4, c1), bd)
    plane[yp_ - 1, cols] = p0
    plane[yp_ - 2, cols] = p1
    plane[yp_ - 3, cols] = p2
    plane[yp_, cols] = q0
    plane[yp_ + 1, cols] = q1
    plane[yp_ + 2, cols] = q2


def _chroma_edge_ver(plane, yc, xc, bs, alpha, beta, c0, bd, nrows):
    rows = slice(yc, yc + nrows)
    p = tuple(plane[rows, xc - 1 - k].astype(np.int32) for k in range(2))
    q = tuple(plane[rows, xc + k].astype(np.int32) for k in range(2))
    p0, q0 = AC.chroma_line(np, p, q, np.full(nrows, bs),
                            np.full(nrows, alpha), np.full(nrows, beta),
                            np.full(nrows, c0), bd)
    plane[rows, xc - 1] = p0
    plane[rows, xc] = q0


def _chroma_edge_hor(plane, yc, xc, bs, alpha, beta, c0, bd, ncols):
    cols = slice(xc, xc + ncols)
    p = tuple(plane[yc - 1 - k, cols].astype(np.int32) for k in range(2))
    q = tuple(plane[yc + k, cols].astype(np.int32) for k in range(2))
    p0, q0 = AC.chroma_line(np, p, q, np.full(ncols, bs),
                            np.full(ncols, alpha), np.full(ncols, beta),
                            np.full(ncols, c0), bd)
    plane[yc - 1, cols] = p0
    plane[yc, cols] = q0


def deblock_frame_addb(planes, job, sps):
    """Apply ADDB to (y, u, v) in place."""
    y_plane, u_plane, v_plane = planes
    bd_l = sps.bit_depth_luma_minus8 + 8
    bd_c = sps.bit_depth_chroma_minus8 + 8
    cfi = sps.chroma_format_idc
    luma = job.addb_luma
    chroma = job.addb_chroma
    for d in (0, 1):                        # ver pass, then hor pass
        ys, xs = np.nonzero(luma[d, :, :, 0])
        for ys_, xs_ in zip(ys, xs):
            bs, alpha, beta, c1 = (int(v) for v in luma[d, ys_, xs_])
            if d == 0:
                _luma_edge_ver(y_plane, ys_, xs_ * 4, bs, alpha, beta,
                               c1, bd_l)
            else:
                _luma_edge_hor(y_plane, ys_ * 4, xs_, bs, alpha, beta,
                               c1, bd_l)
        if not cfi:
            continue
        ys, xs = np.nonzero(chroma[d, :, :, 0])
        for ys_, xs_ in zip(ys, xs):
            row = chroma[d, ys_, xs_]
            bs = int(row[0])
            for plane, (a, b, c0) in ((u_plane, row[1:4]),
                                      (v_plane, row[4:7])):
                if d == 0:
                    _chroma_edge_ver(plane, ys_ * 2, xs_ * 2, bs, int(a),
                                     int(b), int(c0), bd_c, 2)
                else:
                    _chroma_edge_hor(plane, ys_ * 2, xs_ * 2, bs, int(a),
                                     int(b), int(c0), bd_c, 2)
