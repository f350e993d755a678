"""ADDB (advanced deblocking) line filters, backend-neutral.

The per-line filter math of the Main-profile adaptive deblocking filter
(ref: src_main/xevdm_df.c:550-781), written against an array module `xp`
(numpy for the host oracle, jax.numpy for the device kernels).  All edges
sit on an 8x8 luma grid and the filters touch at most 3 pixels a side, so
unlike the Baseline filter there are NO cascades: every edge of a pass is
independent and both backends apply them fully vectorized.

Inputs are int32 tap arrays p0..p3 / q0..q3 (p = left/up side, p0 adjacent
to the edge) plus per-edge parameter arrays (bs, alpha, beta, c1/c0)
broadcast to the tap shape.  Outputs are the filtered taps.
"""
from __future__ import annotations


def _clip3(xp, lo, hi, v):
    return xp.minimum(xp.maximum(v, lo), hi)


def luma_line(xp, p, q, bs, alpha, beta, c1, bd):
    """Filter one batch of luma lines.  p, q: tuples (x0, x1, x2, x3) of
    int32 arrays; returns ((p0..p2), (q0..q2)) filtered
    (ref: src_main/xevdm_df.c:584-709)."""
    p0, p1, p2, p3 = p
    q0, q1, q2, q3 = q
    maxv = (1 << bd) - 1
    apply = ((bs > 0) & (xp.abs(p0 - q0) < alpha)
             & (xp.abs(p1 - p0) < beta) & (xp.abs(q1 - q0) < beta))
    ap = xp.abs(p0 - p2) < beta
    aq = xp.abs(q0 - q2) < beta

    # strong (DBF_ADDB_BS_INTRA_STRONG) path (:633-651)
    sthr = xp.abs(p0 - q0) < ((alpha >> 2) + 2)
    ps0 = (p2 + 2 * (p1 + p0 + q0) + q1 + 4) >> 3
    ps1 = (p2 + p1 + p0 + q0 + 2) >> 2
    ps2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    pw0 = (2 * p1 + p0 + q1 + 2) >> 2
    qs0 = (q2 + 2 * (q1 + q0 + p0) + p1 + 4) >> 3
    qs1 = (q2 + q1 + q0 + p0 + 2) >> 2
    qs2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    qw0 = (2 * q1 + q0 + p1 + 2) >> 2
    p_on = ap & sthr
    q_on = aq & sthr
    st_p0 = xp.where(p_on, ps0, pw0)
    st_p1 = xp.where(p_on, ps1, p1)
    st_p2 = xp.where(p_on, ps2, p2)
    st_q0 = xp.where(q_on, qs0, qw0)
    st_q1 = xp.where(q_on, qs1, q1)
    st_q2 = xp.where(q_on, qs2, q2)

    # normal path (:652-690)
    shift = max(0, bd - 9)
    c0 = c1 + ((ap.astype(c1.dtype) + aq.astype(c1.dtype)) << shift)
    d0 = _clip3(xp, -c0, c0, (4 * (q0 - p0) + p1 - q1 + 4) >> 3)
    no_p0 = _clip3(xp, 0, maxv, p0 + d0)
    no_q0 = _clip3(xp, 0, maxv, q0 - d0)
    d1p = _clip3(xp, -c1, c1, ((p2 + p0 + q0) * 3 - 8 * p1 - q1) >> 4)
    d1q = _clip3(xp, -c1, c1, ((q2 + q0 + p0) * 3 - 8 * q1 - p1) >> 4)
    no_p1 = xp.where(ap, p1 + d1p, p1)
    no_q1 = xp.where(aq, q1 + d1q, q1)

    strong = bs == 4
    f_p0 = xp.where(strong, st_p0, no_p0)
    f_p1 = xp.where(strong, st_p1, no_p1)
    f_p2 = xp.where(strong, st_p2, p2)
    f_q0 = xp.where(strong, st_q0, no_q0)
    f_q1 = xp.where(strong, st_q1, no_q1)
    f_q2 = xp.where(strong, st_q2, q2)
    # final clip of taps 0..2 (:691-699)
    f_p0 = _clip3(xp, 0, maxv, f_p0)
    f_p1 = _clip3(xp, 0, maxv, f_p1)
    f_p2 = _clip3(xp, 0, maxv, f_p2)
    f_q0 = _clip3(xp, 0, maxv, f_q0)
    f_q1 = _clip3(xp, 0, maxv, f_q1)
    f_q2 = _clip3(xp, 0, maxv, f_q2)

    out_p0 = xp.where(apply, f_p0, p0)
    out_p1 = xp.where(apply, f_p1, p1)
    out_p2 = xp.where(apply, f_p2, p2)
    out_q0 = xp.where(apply, f_q0, q0)
    out_q1 = xp.where(apply, f_q1, q1)
    out_q2 = xp.where(apply, f_q2, q2)
    return (out_p0, out_p1, out_p2), (out_q0, out_q1, out_q2)


def chroma_line(xp, p, q, bs, alpha, beta, c0, bd):
    """Filter one batch of chroma lines.  p, q: tuples (x0, x1); only x0
    changes (ref: src_main/xevdm_df.c:710-781)."""
    p0, p1 = p
    q0, q1 = q
    maxv = (1 << bd) - 1
    apply = ((bs > 0) & (xp.abs(p0 - q0) < alpha)
             & (xp.abs(p1 - p0) < beta) & (xp.abs(q1 - q0) < beta))
    st_p0 = (2 * p1 + p0 + q1 + 2) >> 2
    st_q0 = (2 * q1 + q0 + p1 + 2) >> 2
    d0 = _clip3(xp, -c0, c0, (4 * (q0 - p0) + p1 - q1 + 4) >> 3)
    no_p0 = _clip3(xp, 0, maxv, p0 + d0)
    no_q0 = _clip3(xp, 0, maxv, q0 - d0)
    strong = bs == 4
    f_p0 = _clip3(xp, 0, maxv, xp.where(strong, st_p0, no_p0))
    f_q0 = _clip3(xp, 0, maxv, xp.where(strong, st_q0, no_q0))
    out_p0 = xp.where(apply, f_p0, p0)
    out_q0 = xp.where(apply, f_q0, q0)
    return out_p0, out_q0
