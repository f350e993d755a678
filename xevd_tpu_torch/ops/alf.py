"""ALF, the Main profile's adaptive loop filter (the port of K13
`alf_apply`, xevd_tpu/ops/jax_alf.py:150-230, with `_fix_margins` :32,
`_classify` :54, `_filter_luma` :124 and `_filter_chroma` :139).

Each CTU is filtered from a (S + 6)^2 window of the PRE-ALF picture (S the
CTU size, S/2 for chroma): the picture replicate-extended, then mirrored at
the CTU's unavailable sides.  Luma classifies each 4x4 block by its
gradients (25 classes x 4 transposes) and applies the 7x7 diamond with the
class's coefficients; chroma applies one 5x5 diamond.  Luma CTUs are
filtered where their `ctu_on` flag is set, chroma CTUs always (as the JAX
mask, jax_alf.py:222-224).  `alf_frame` reads the deblocked areas, leaves
them untouched and returns the planes pad reads, new output planes where it
filtered (luma CTUs whose flag is off copied): on CUDA tensors from
csrc/alf.cu's one kernel a picture, on CPU tensors from `alf_runs_ref`,
which states the kernel's split: Laplacians summed once into 4x4 groups,
and a filter run of 4 samples with one row of the transposed coefficient
table."""
from __future__ import annotations

import torch

from ..host.ops.alf import _ACT_TH, _L_TBL, _TAPS5, _TAPS7, _TRANS_TBL
from ..kernels import build as K

M = 3       # window margin


def _wrap32(x):
    """int64 values wrapped to int32, as the reference's int products."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _windows(src, ph, pw, log2_s, across):
    """[N, S + 6, S + 6] int32 windows of every CTU of the ph x pw area
    (replicate-extended, mirrored by `_fix_margins`' rules), and the CTU
    origins ys, xs and sizes hb, wb [N] (int64)."""
    S = 1 << log2_s
    n_w, n_h = -(-pw // S), -(-ph // S)
    dev = src.device
    idx = torch.arange(n_w * n_h, device=dev)
    xs, ys = (idx % n_w) * S, (idx // n_w) * S
    wb = torch.clamp(pw - xs, max=S)
    hb = torch.clamp(ph - ys, max=S)
    av_l, av_t = xs > 0, ys > 0
    if across:
        av_r = av_b = torch.ones_like(av_l)
    else:
        av_r, av_b = xs + wb != pw, ys + hb != ph
    n = S + 2 * M
    r = torch.arange(n, device=dev)
    col = lambda t: t[:, None, None]          # noqa: E731  per CTU
    rr, cc = r[None, :, None], r[None, None, :]
    # _fix_margins (jax_alf.py:32-51): columns, then rows; the side
    # mirrors only where the mapped row is a CTU interior row
    ccm = torch.where(~col(av_l) & (cc < M), 2 * M - cc, cc)
    ccm = torch.where(~col(av_r) & (cc >= M + col(wb)),
                      2 * (M + col(wb)) - ccm - 2, ccm)
    rrm = torch.where(~col(av_t) & (rr < M), 2 * M - rr, rr)
    rrm = torch.where(~col(av_b) & (rr >= M + col(hb)),
                      2 * (M + col(hb)) - rrm - 2, rrm)
    interior = (rrm >= M) & (rrm < M + col(hb))
    ccm = torch.where(interior, ccm, cc)
    rrm = rrm.clamp(0, n - 1)
    ccm = ccm.clamp(0, n - 1)
    # window -> replicate-extended picture -> area
    rows = (col(ys) + rrm - M).clamp(0, ph - 1)
    cols = (col(xs) + ccm - M).clamp(0, pw - 1)
    bufs = src[rows, cols].to(torch.int32)
    return bufs, ys, xs, hb, wb


def _group_sums(bufs, S):
    """The four Laplacians (vertical, horizontal, two diagonals) of window
    rows and columns 1 .. S + 4, once a sample, summed by 4 x 4 group:
    int64 [N, 4, S/4 + 1, S/4 + 1], group (gi, gj) covering rows
    1 + 4 gi .. 4 + 4 gi and the same columns."""
    c = bufs[:, 1:-1, 1:-1]
    up, dn = bufs[:, :-2, 1:-1], bufs[:, 2:, 1:-1]
    lf, rt = bufs[:, 1:-1, :-2], bufs[:, 1:-1, 2:]
    ul, dr = bufs[:, :-2, :-2], bufs[:, 2:, 2:]
    dl, ur = bufs[:, 2:, :-2], bufs[:, :-2, 2:]
    lap = torch.stack([(2 * c - up - dn).abs(), (2 * c - lf - rt).abs(),
                       (2 * c - ul - dr).abs(), (2 * c - dl - ur).abs()], 1)
    g = S // 4 + 1
    return lap.reshape(lap.shape[0], 4, g, 4, g, 4).sum((3, 5)).to(
        torch.int64)


def _classify(bufs, bd, S):
    """(class, trans) per 4x4 block [N, S/4, S/4] (jax_alf.py:54-121):
    block (i, j) sums the four Laplacians over window rows and columns
    M - 2 + 4 i .. M + 5 + 4 i (an 8 x 8 area), its four groups (i .. i + 1,
    j .. j + 1) of `_group_sums`."""
    g = _group_sums(bufs, S)
    b = g[..., :-1, :-1] + g[..., :-1, 1:] + g[..., 1:, :-1] + g[..., 1:, 1:]
    sv, sh, sd0, sd1 = b.unbind(1)
    act = ((sv + sh) >> (bd - 2)).clamp(0, 15)
    cls = torch.as_tensor(_ACT_TH, device=bufs.device).to(torch.int64)[act]
    hv1, hv0 = torch.maximum(sv, sh), torch.minimum(sv, sh)
    dir_hv = torch.where(sv > sh, 1, 3)
    d1, d0 = torch.maximum(sd0, sd1), torch.minimum(sd0, sd1)
    dir_d = torch.where(sd0 > sd1, 0, 2)
    # wrapping 32-bit products (jax_alf.py:109-111)
    use_d = _wrap32(d1 * hv0) > _wrap32(hv1 * d0)
    hvd1 = torch.where(use_d, d1, hv1)
    hvd0 = torch.where(use_d, d0, hv0)
    main_dir = torch.where(use_d, dir_d, dir_hv)
    sec_dir = torch.where(use_d, dir_hv, dir_d)
    ds = torch.where(hvd1 > 2 * hvd0, 1, 0)
    ds = torch.where(hvd1 * 2 > 9 * hvd0, 2, ds)
    cls = torch.where(ds > 0, cls + (((main_dir & 1) << 1) + ds) * 5, cls)
    trans = torch.as_tensor(_TRANS_TBL, device=bufs.device).to(
        torch.int64)[main_dir * 2 + (sec_dir >> 1)]
    return cls, trans


def _tap_sums(bufs, taps, S):
    return [sum(bufs[:, M + dy:M + dy + S, M + dx:M + dx + S]
                for dy, dx in pair) for pair in taps]


def coef_table(coef):
    """The luma coefficients permuted by transpose, int32 [25, 4, 13]:
    row (class, trans) holds coef[class][L_TBL[trans][i]] at tap i, the
    table the kernel stages once a CTA."""
    return coef.to(torch.int32)[:, torch.as_tensor(_L_TBL,
                                                   device=coef.device).long()]


def alf_runs_ref(area, coef, ctu_on, ph, pw, log2_s, bd, across, luma):
    """One plane of `alf_apply` in the kernel's split, returned as a new
    int16 [ph, pw] plane: luma blocks classified from the group sums, then
    each run of 4 samples of a block's row filtered with the one row
    coef_table(coef)[class, trans] (luma) or the 7 chroma taps, the run's
    window rows read once for its four outputs; luma CTUs whose flag is off
    copied from the area."""
    S = 1 << log2_s
    bufs, ys, xs, hb, wb = _windows(area[:ph, :pw], ph, pw, log2_s, across)
    N, R = bufs.shape[0], S // 4
    taps = _TAPS7 if luma else _TAPS5
    # tap i's sum at sample (j, 4 k + q) of each CTU: [N, S, R, 4]
    sums = [s.reshape(N, S, R, 4) for s in _tap_sums(bufs, taps, S)]
    if luma:
        cls, trans = _classify(bufs, bd, S)
        rows = coef_table(coef)[cls, trans]               # [N, R, R, 13]
        rows = rows.repeat_interleave(4, 1)               # a row per run
        acc = sum(rows[..., i, None] * s for i, s in enumerate(sums))
    else:
        acc = sum(int(coef[i]) * s for i, s in enumerate(sums))
    vals = ((acc + 256) >> 9).clamp(0, (1 << bd) - 1).reshape(N, S, S)
    if luma:
        on = ctu_on.to(area.device)[:, None, None] > 0
        vals = torch.where(on, vals, bufs[:, M:M + S, M:M + S])
    out = torch.empty(ph, pw, dtype=area.dtype, device=area.device)
    j = torch.arange(S, device=area.device)
    m = (j[None, None, :] < wb[:, None, None]) & \
        (j[None, :, None] < hb[:, None, None])
    yy = (ys[:, None, None] + j[None, :, None]).expand_as(m)[m]
    xx = (xs[:, None, None] + j[None, None, :]).expand_as(m)[m]
    out[yy, xx] = vals[m].to(area.dtype)
    return out


def _planes(y_area, u_area, v_area, h, w, cfg):
    """(plane index, area, ph, pw, log2_s) of each plane ALF filters
    (index 0 is luma)."""
    enables, log2_ctu, _ = cfg
    return [(i, a, h >> (i > 0), w >> (i > 0), log2_ctu - (i > 0))
            for i, a in enumerate((y_area, u_area, v_area))
            if a is not None and enables[i]]


def _check(area, coef, ctu_on, ph, pw, log2_s, luma):
    if area.shape[0] < ph or area.shape[1] < pw:
        raise ValueError(f"alf: area {tuple(area.shape)} smaller than "
                         f"{ph}x{pw}")
    n_ctu = -(-ph >> log2_s) * -(-pw >> log2_s)
    if coef.shape != ((25, 13) if luma else (7,)) or (
            luma and ctu_on.shape != (n_ctu,)):
        raise ValueError(f"alf: coefficients {tuple(coef.shape)}, CTU flags "
                         f"{None if ctu_on is None else tuple(ctu_on.shape)}"
                         f" for {n_ctu} CTUs")


def alf_frame_ref(y_area, u_area, v_area, coef_l, coef_c, ctu_on, h, w, cfg,
                  bd):
    """The plain version of `alf_frame` (any device): the (y, u, v) planes
    pad reads, `alf_runs_ref`'s new plane for each plane ALF filters, the
    area for each it does not; the areas are left untouched."""
    out = [y_area, u_area, v_area]
    for i, area, ph, pw, log2_s in _planes(*out, h, w, cfg):
        out[i] = alf_runs_ref(area, coef_c if i else coef_l, ctu_on, ph, pw,
                              log2_s, bd, cfg[2], i == 0)
    return tuple(out)


def alf_frame(y_area, u_area, v_area, coef_l, coef_c, ctu_on, h, w, cfg, bd):
    """The ALF stage (xevd_tpu/ops/pipeline.py:377-389 -> alf_apply): cfg =
    (enables, log2_ctu, across); luma when enables[0], U / V when
    enables[1] / enables[2] (u_area / v_area None for 4:0:0).  Returns the
    (y, u, v) planes pad reads, each filtered plane a new int16 [ph, pw]
    tensor (a plane not filtered is its area), and leaves the areas
    untouched: on CUDA tensors from one launch, on CPU tensors from
    `alf_frame_ref`."""
    planes = _planes(y_area, u_area, v_area, h, w, cfg)
    for i, area, ph, pw, log2_s in planes:
        _check(area, coef_c if i else coef_l, ctu_on, ph, pw, log2_s, i == 0)
    if y_area.device.type == "cpu":
        return alf_frame_ref(y_area, u_area, v_area, coef_l, coef_c, ctu_on,
                             h, w, cfg, bd)
    out = [y_area, u_area, v_area]
    if not planes:
        return tuple(out)
    args, mask, wide = [None, 0, None, 0] * 3, 0, 0
    for i, area, ph, pw, _ in planes:
        K.require(area, torch.int16, 2, rows_contiguous=True)
        # the output's pitch a multiple of 4 samples: aligned 8-byte words
        dst = torch.empty(ph, (pw + 3) & ~3, dtype=torch.int16,
                          device=area.device)
        if area.data_ptr() % 8 == 0 and area.stride(0) % 4 == 0:
            wide |= 1 << i
        mask |= 1 << i
        args[4 * i:4 * i + 4] = (area.data_ptr(), area.stride(0),
                                 dst.data_ptr(), dst.stride(0))
        out[i] = dst[:, :pw]
    luma, chroma = mask & 1, mask & 6
    if luma:
        K.require(coef_l, torch.int32, 2, contiguous=True)
        K.require(ctu_on, torch.int32, 1, contiguous=True)
    if chroma:
        K.require(coef_c, torch.int32, 1, contiguous=True)
    K.count("alf_frame")
    err = K.lib().xevd_alf_frame(
        *args, h, w, cfg[1], mask, wide,
        coef_l.data_ptr() if luma else None,
        ctu_on.data_ptr() if luma else None,
        coef_c.data_ptr() if chroma else None, int(cfg[2]), bd,
        K.stream_ptr(y_area.device))
    K.check(err, "xevd_alf_frame")
    return tuple(out)
