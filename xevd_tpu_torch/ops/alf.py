"""ALF, the Main profile's adaptive loop filter (the port of K13
`alf_apply`, xevd_tpu/ops/jax_alf.py:150-230, with `_fix_margins` :32,
`_classify` :54, `_filter_luma` :124 and `_filter_chroma` :139).

Each CTU is filtered from a (S + 6)^2 window of the PRE-ALF picture (S the
CTU size, S/2 for chroma): the picture replicate-extended, then mirrored at
the CTU's unavailable sides.  Luma classifies each 4x4 block by its
gradients (25 classes x 4 transposes) and applies the 7x7 diamond with the
class's coefficients; chroma applies one 5x5 diamond.  Luma CTUs are
written where their `ctu_on` flag is set, chroma CTUs always (as the JAX
mask, jax_alf.py:222-224).  The output goes back into the area in place;
every CTU reads a copy of the pre-ALF area.  CUDA tensors launch the
kernels of csrc/alf.cu, CPU tensors take `alf_plane_ref`."""
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


def _classify(bufs, bd, S):
    """(class << 2) | trans per 4x4 block [N, S/4, S/4] (jax_alf.py:54-121):
    block (i, j) sums the four Laplacians over window rows and columns
    M - 2 + 4 i .. M + 5 + 4 i (an 8 x 8 area)."""
    c = bufs[:, 1:-1, 1:-1]                   # window rows/cols 1..S+4
    up, dn = bufs[:, :-2, 1:-1], bufs[:, 2:, 1:-1]
    lf, rt = bufs[:, 1:-1, :-2], bufs[:, 1:-1, 2:]
    ul, dr = bufs[:, :-2, :-2], bufs[:, 2:, 2:]
    dl, ur = bufs[:, 2:, :-2], bufs[:, :-2, 2:]
    nb = S // 4

    def bsum(lap):
        g = lap.reshape(lap.shape[0], nb + 1, 4, nb + 1, 4).sum((2, 4))
        g = g[:, :-1] + g[:, 1:]
        return (g[:, :, :-1] + g[:, :, 1:]).to(torch.int64)

    sv = bsum((2 * c - up - dn).abs())
    sh = bsum((2 * c - lf - rt).abs())
    sd0 = bsum((2 * c - ul - dr).abs())
    sd1 = bsum((2 * c - dl - ur).abs())
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


def alf_plane_ref(area, coef, ctu_on, ph, pw, log2_s, bd, across, luma):
    """One plane of `alf_apply` in place on `area` (only its ph x pw part is
    read and written), vectorised over CTUs: luma with coef [25, 13] and
    the CTU flags ctu_on [N], chroma (`luma` False) with coef [7]."""
    S = 1 << log2_s
    bufs, ys, xs, hb, wb = _windows(area[:ph, :pw].clone(), ph, pw, log2_s,
                                    across)
    sums = _tap_sums(bufs, _TAPS7 if luma else _TAPS5, S)
    if luma:
        cls, trans = _classify(bufs, bd, S)
        ltbl = torch.as_tensor(_L_TBL, device=area.device).to(torch.int64)
        co = coef.to(torch.int32)[cls[..., None], ltbl[trans]]  # [N,nb,nb,13]
        co = co.repeat_interleave(4, 1).repeat_interleave(4, 2)
        acc = sum(co[..., i] * s for i, s in enumerate(sums))
    else:
        acc = sum(int(coef[i]) * s for i, s in enumerate(sums))
    vals = ((acc + 256) >> 9).clamp(0, (1 << bd) - 1).to(area.dtype)
    j = torch.arange(S, device=area.device)
    m = (j[None, None, :] < wb[:, None, None]) & \
        (j[None, :, None] < hb[:, None, None])
    if luma:
        m &= ctu_on.to(area.device)[:, None, None] > 0
    yy = (ys[:, None, None] + j[None, :, None]).expand_as(m)[m]
    xx = (xs[:, None, None] + j[None, None, :]).expand_as(m)[m]
    area[yy, xx] = vals[m]


def alf_plane(area, coef, ctu_on, ph, pw, log2_s, bd, across, luma):
    """ALF of one plane in place on `area` [>= ph, >= pw] int16: luma
    (coef int32 [25, 13], ctu_on int32 [N]) or chroma (coef int32 [7],
    ctu_on unused) with CTU size 2^log2_s of this plane."""
    if area.shape[0] < ph or area.shape[1] < pw:
        raise ValueError(f"alf: area {tuple(area.shape)} smaller than "
                         f"{ph}x{pw}")
    n_ctu = -(-ph >> log2_s) * -(-pw >> log2_s)
    if coef.shape != ((25, 13) if luma else (7,)) or (
            luma and ctu_on.shape != (n_ctu,)):
        raise ValueError(f"alf: coefficients {tuple(coef.shape)}, CTU flags "
                         f"{None if ctu_on is None else tuple(ctu_on.shape)}"
                         f" for {n_ctu} CTUs")
    if area.device.type == "cpu":
        alf_plane_ref(area, coef, ctu_on, ph, pw, log2_s, bd, across, luma)
        return area
    K.require(area, torch.int16, 2, rows_contiguous=True)
    K.require(coef, torch.int32, 2 if luma else 1, contiguous=True)
    if luma:
        K.require(ctu_on, torch.int32, 1, contiguous=True)
    src = area[:ph, :pw].clone()     # every CTU reads the pre-ALF picture
    name = "alf_luma" if luma else "alf_chroma"
    K.count(name)
    err = getattr(K.lib(), f"xevd_{name}")(
        src.data_ptr(), src.stride(0), area.data_ptr(), area.stride(0), ph,
        pw, log2_s, coef.data_ptr(), ctu_on.data_ptr() if luma else None,
        int(across), bd, K.stream_ptr(area.device))
    K.check(err, f"xevd_{name}")
    return area


def alf_frame(y_area, u_area, v_area, coef_l, coef_c, ctu_on, h, w, cfg, bd):
    """The ALF stage (xevd_tpu/ops/pipeline.py:377-389 -> alf_apply): cfg =
    (enables, log2_ctu, across); luma when enables[0], U / V when
    enables[1] / enables[2] (u_area / v_area None for 4:0:0)."""
    enables, log2_ctu, across = cfg
    if enables[0]:
        alf_plane(y_area, coef_l, ctu_on, h, w, log2_ctu, bd, across, True)
    if u_area is not None:
        for area, en in ((u_area, enables[1]), (v_area, enables[2])):
            if en:
                alf_plane(area, coef_c, None, h >> 1, w >> 1, log2_ctu - 1,
                          bd, across, False)
