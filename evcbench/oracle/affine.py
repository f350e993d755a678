"""Affine motion toolbox: merge/AMVP candidate derivation, sub-block
size/EIF decisions, and the sub-block motion field.

Shared by the decoder's derive pass (derive.py) and the test-stream
generator (tools/evc_enc.py), like motion.py.  Behavioral reference:
src_main/xevdm_util.c:1870-3189 (candidates, sub-block size, EIF
applicability, set_affine_mvf :4095-4202), src_main/xevdm.c:938-1040
(recon-side selection), :657-800 (HMVP center-MV update).
"""
from __future__ import annotations

from . import tables as T
from .motion import (LR_01, LR_10, LR_11, REFI_INVALID, MotionMaps,
                     get_mv_collocated, _s16c)

VER_NUM = 4
AFF_MAX_CAND = 5
AFF_MODEL_CAND = 5
AFF_MAX_NUM_MVP = 2
AFFINE_ADAPT_EIF_SIZE = 8
EIF_SUBBLOCK_SIZE = 4
EIF_NUM_ALLOWED_FETCHED_LINES_FOR_THE_FIRST_LINE = 3
MAX_MEMORY_ACCESS_BI = 72
MAX_CU_LOG2 = 7


def mv_rounding(hor, ver, right_shift, left_shift=0):
    """(ref: src_main/xevdm_util.c:1857-1862 xevdm_mv_rounding_s32)"""
    offset = (1 << (right_shift - 1)) if right_shift > 0 else 0
    h = ((hor + offset - (1 if hor >= 0 else 0)) >> right_shift) << left_shift
    v = ((ver + offset - (1 if ver >= 0 else 0)) >> right_shift) << left_shift
    return h, v


def rounding_s32(comp, right_shift, left_shift=0):
    """(ref: src_main/xevdm_util.c:1864-1869)"""
    offset = (1 << (right_shift - 1)) if right_shift > 0 else 0
    return ((comp + offset - (1 if comp >= 0 else 0)) >> right_shift) \
        << left_shift


def _model_params(ac_mv, cuw, cuh, vertex_num, prec):
    """d_hor/d_ver deltas at 2^prec precision
    (ref: calculate_affine_motion_model_parameters)."""
    lw, lh = int(T.TBL_LOG2[cuw]), int(T.TBL_LOG2[cuh])
    d_hor = [((ac_mv[1][c] - ac_mv[0][c]) << prec) >> lw for c in range(2)]
    if vertex_num == 3:
        d_ver = [((ac_mv[2][c] - ac_mv[0][c]) << prec) >> lh
                 for c in range(2)]
    else:
        d_ver = [-d_hor[1], d_hor[0]]
    return d_hor, d_ver


def _bounding_box(w, h, d_hor, d_ver, mv_precision):
    """(ref: calculate_bounding_box_size)"""
    cx = [0, (w + 1) * (d_hor[0] + (1 << mv_precision)), (h + 1) * d_ver[0]]
    cx.append(cx[1] + cx[2] - cx[0])
    cy = [0, (w + 1) * d_hor[1], (h + 1) * (d_ver[1] + (1 << mv_precision))]
    cy.append(cy[1] + cy[2] - cy[0])
    out = []
    for c in (cx, cy):
        diff = (max(c) - min(c) + (1 << mv_precision) - 1) >> mv_precision
        out.append(diff + 1 + 1)
    return out[0], out[1]


def check_eif_applicability_uni(ac_mv, cuw, cuh, vertex_num):
    """Returns (applicable, mem_band_ok)
    (ref: xevdm_check_eif_applicability_uni)."""
    prec_add = MAX_CU_LOG2
    mv_precision = 2 + prec_add
    d_hor, d_ver = _model_params(ac_mv, cuw, cuh, vertex_num, prec_add)
    bw, bh = _bounding_box(EIF_SUBBLOCK_SIZE, EIF_SUBBLOCK_SIZE, d_hor,
                           d_ver, mv_precision)
    mem_band_ok = bw * bh <= MAX_MEMORY_ACCESS_BI
    # fetched-lines restriction
    if d_ver[1] < -(1 << mv_precision):
        return False, mem_band_ok
    if (max(0, d_ver[1]) + abs(d_hor[1])) * (1 + EIF_SUBBLOCK_SIZE) > \
            (EIF_NUM_ALLOWED_FETCHED_LINES_FOR_THE_FIRST_LINE - 2) \
            << mv_precision:
        return False, mem_band_ok
    return True, mem_band_ok


def check_eif_applicability_bi(ac_mv2, refi, cuw, cuh, vertex_num):
    """(ref: xevdm_check_eif_applicability_bi)"""
    mem_band = True
    for lidx in range(2):
        if refi[lidx] >= 0:
            ok, mb = check_eif_applicability_uni(ac_mv2[lidx], cuw, cuh,
                                                 vertex_num)
            mem_band = mem_band and mb
            if not ok:
                return False, mem_band
    return True, mem_band


def _subblock_wh(ac_mv, cuw, cuh, vertex_num):
    d_hor, d_ver = _model_params(ac_mv, cuw, cuh, vertex_num, 7)
    mv_wx = max(abs(d_hor[0]), abs(d_hor[1]))
    mv_wy = max(abs(d_ver[0]), abs(d_ver[1]))
    sub_lut = [32, 16, 8, 8]
    w = 4 if mv_wx > 4 else (cuw if mv_wx == 0 else sub_lut[mv_wx - 1])
    h = 4 if mv_wy > 4 else (cuh if mv_wy == 0 else sub_lut[mv_wy - 1])
    return w, h


def derive_affine_subblock_size(ac_mv, cuw, cuh, vertex_num):
    """Uni-dir sub-block size (ref: xevdm_derive_affine_subblock_size).
    Returns (sub_w, sub_h, mem_band_ok)."""
    sub_w, sub_h = _subblock_wh(ac_mv, cuw, cuh, vertex_num)
    apply_eif, mem_band_ok = check_eif_applicability_uni(ac_mv, cuw, cuh,
                                                         vertex_num)
    if not apply_eif:
        sub_w = max(sub_w, AFFINE_ADAPT_EIF_SIZE)
        sub_h = max(sub_h, AFFINE_ADAPT_EIF_SIZE)
    return sub_w, sub_h, mem_band_ok


def derive_affine_subblock_size_bi(ac_mv2, refi, cuw, cuh, vertex_num):
    """Bi-dir sub-block size (ref: xevdm_derive_affine_subblock_size_bi).
    Returns (sub_w, sub_h, mem_band_ok)."""
    sub_w, sub_h = cuw, cuh
    for lidx in range(2):
        if refi[lidx] >= 0:
            w, h = _subblock_wh(ac_mv2[lidx], cuw, cuh, vertex_num)
            sub_w = min(sub_w, w)
            sub_h = min(sub_h, h)
    apply_eif, mem_band_ok = check_eif_applicability_bi(ac_mv2, refi, cuw,
                                                        cuh, vertex_num)
    if not apply_eif:
        sub_w = max(sub_w, AFFINE_ADAPT_EIF_SIZE)
        sub_h = max(sub_h, AFFINE_ADAPT_EIF_SIZE)
    return sub_w, sub_h, mem_band_ok


class AffineMaps:
    """Per-SCU affine state carried alongside MotionMaps: the affine flag
    (0/1/2) and the owning CU geometry (ref: map_affine MCU_*_AFF_* bits,
    src_main/xevdm_def.h:317-358)."""

    def __init__(self, w_scu, h_scu):
        import numpy as np
        self.aff = np.zeros((h_scu, w_scu), dtype=np.uint8)
        self.logw = np.zeros((h_scu, w_scu), dtype=np.uint8)
        self.logh = np.zeros((h_scu, w_scu), dtype=np.uint8)
        self.xoff = np.zeros((h_scu, w_scu), dtype=np.uint16)
        self.yoff = np.zeros((h_scu, w_scu), dtype=np.uint16)

    def set_cu(self, x_scu, y_scu, scuw, scuh, aff_flag, log2w, log2h):
        ys, xs = slice(y_scu, y_scu + scuh), slice(x_scu, x_scu + scuw)
        self.aff[ys, xs] = aff_flag
        if aff_flag:
            import numpy as np
            self.logw[ys, xs] = log2w
            self.logh[ys, xs] = log2h
            self.xoff[ys, xs] = np.arange(scuw, dtype=np.uint16)[None, :]
            self.yoff[ys, xs] = np.arange(scuh, dtype=np.uint16)[:, None]


def derive_affine_model_mv(mm: MotionMaps, am: AffineMaps, scup_yx,
                           scun_yx, lidx, cuw, cuh, cur_cp_num,
                           log2_max_cuwh):
    """Inherited CPMV derivation from an affine neighbor
    (ref: xevdm_derive_affine_model_mv).  Returns mvp[3][2]."""
    w_scu = mm.w_scu
    ny, nx = scun_yx
    neb_log_w = int(am.logw[ny, nx])
    neb_log_h = int(am.logh[ny, nx])
    neb_w, neb_h = 1 << neb_log_w, 1 << neb_log_h
    base_y = ny - int(am.yoff[ny, nx])
    base_x = nx - int(am.xoff[ny, nx])
    addrs = [(base_y, base_x),
             (base_y, base_x + (neb_w >> 2) - 1),
             (base_y + (neb_h >> 2) - 1, base_x),
             (base_y + (neb_h >> 2) - 1, base_x + (neb_w >> 2) - 1)]
    neb_mv = [[int(mm.map_mv[p][lidx][0]), int(mm.map_mv[p][lidx][1])]
              for p in addrs]
    neb_x = base_x << 2
    neb_y = base_y << 2
    cy, cx = scup_yx
    cur_x, cur_y = cx << 2, cy << 2
    max_bit = 7
    diff_w = max_bit - neb_log_w
    diff_h = max_bit - neb_log_h

    is_top_ctu_boundary = False
    if (neb_y + neb_h) % (1 << log2_max_cuwh) == 0 and \
            (neb_y + neb_h) == cur_y:
        is_top_ctu_boundary = True
        neb_y += neb_h
        neb_mv[0] = list(neb_mv[2])
        neb_mv[1] = list(neb_mv[3])

    dmv_hor_x = (neb_mv[1][0] - neb_mv[0][0]) << diff_w
    dmv_hor_y = (neb_mv[1][1] - neb_mv[0][1]) << diff_w
    if cur_cp_num == 3 and not is_top_ctu_boundary:
        dmv_ver_x = (neb_mv[2][0] - neb_mv[0][0]) << diff_h
        dmv_ver_y = (neb_mv[2][1] - neb_mv[0][1]) << diff_h
    else:
        dmv_ver_x = -dmv_hor_y
        dmv_ver_y = dmv_hor_x
    hor_base = neb_mv[0][0] << max_bit
    ver_base = neb_mv[0][1] << max_bit

    mvp = [[0, 0], [0, 0], [0, 0]]
    pts = [(cur_x - neb_x, cur_y - neb_y),
           (cur_x - neb_x + cuw, cur_y - neb_y),
           (cur_x - neb_x, cur_y - neb_y + cuh)]
    n = 3 if cur_cp_num == 3 else 2
    for i in range(n):
        px, py = pts[i]
        th = dmv_hor_x * px + dmv_ver_x * py + hor_base
        tv = dmv_hor_y * px + dmv_ver_y * py + ver_base
        th, tv = mv_rounding(th, tv, max_bit, 0)
        mvp[i] = [_s16c(th), _s16c(tv)]
    return mvp


def _cod_ok(mm, y, x):
    """COD && !IF && AFF on for model candidates."""
    return bool(mm.cod[y, x]) and not bool(mm.map_if[y, x])


def get_affine_merge_candidate(poc, slice_type, mm: MotionMaps,
                               am: AffineMaps, refp, x_scu, y_scu, cuw,
                               cuh, avail_lr, sh, log2_max_cuwh):
    """Affine merge list: up to 5 candidates — inherited model-based then
    constructed control-point based, zero-padded
    (ref: xevdm_get_affine_merge_candidate).
    Returns (refi[5][2], cpmv[5][2][3][2], cp_num[5])."""
    w_scu, h_scu = mm.w_scu, mm.h_scu
    scuw, scuh = cuw >> 2, cuh >> 2
    refi_l = [[REFI_INVALID, REFI_INVALID] for _ in range(AFF_MAX_CAND)]
    cpmv = [[[[0, 0] for _ in range(3)] for _ in range(2)]
            for _ in range(AFF_MAX_CAND)]
    cp_num = [2] * AFF_MAX_CAND
    cnt = 0

    def aff_ok(y, x):
        return _cod_ok(mm, y, x) and am.aff[y, x] != 0

    # ---- model based (inherited) ----
    if avail_lr == LR_01:
        neb = [(y_scu + scuh - 1, x_scu + scuw),   # A1
               (y_scu - 1, x_scu),                 # B1
               (y_scu - 1, x_scu - 1),             # B0
               (y_scu + scuh, x_scu + scuw),       # A0
               (y_scu - 1, x_scu + scuw)]          # B2
        valid = [x_scu + scuw < w_scu and aff_ok(*neb[0]),
                 y_scu > 0 and aff_ok(*neb[1]),
                 x_scu > 0 and y_scu > 0 and aff_ok(*neb[2]),
                 x_scu + scuw < w_scu and y_scu + scuh < h_scu
                 and aff_ok(*neb[3]),
                 y_scu > 0 and x_scu + scuw < w_scu and aff_ok(*neb[4])]
    else:
        neb = [(y_scu + scuh - 1, x_scu - 1),      # A1
               (y_scu - 1, x_scu + scuw - 1),      # B1
               (y_scu - 1, x_scu + scuw),          # B0
               (y_scu + scuh, x_scu - 1),          # A0
               (y_scu - 1, x_scu - 1)]             # B2
        valid = [x_scu > 0 and aff_ok(*neb[0]),
                 y_scu > 0 and aff_ok(*neb[1]),
                 y_scu > 0 and x_scu + scuw < w_scu and aff_ok(*neb[2]),
                 x_scu > 0 and y_scu + scuh < h_scu and aff_ok(*neb[3]),
                 x_scu > 0 and y_scu > 0 and aff_ok(*neb[4])]

    top_left = [None] * 5
    for k in range(5):
        if valid[k]:
            ny, nx = neb[k]
            top_left[k] = (ny - int(am.yoff[ny, nx]),
                           nx - int(am.xoff[ny, nx]))
    if valid[2] and valid[1] and top_left[1] == top_left[2]:
        valid[2] = False
    if valid[3] and valid[0] and top_left[0] == top_left[3]:
        valid[3] = False
    if (valid[4] and valid[0] and top_left[4] == top_left[0]) or \
            (valid[4] and valid[1] and top_left[4] == top_left[1]):
        valid[4] = False

    for k in range(5):
        if valid[k]:
            ny, nx = neb[k]
            cp_num[cnt] = 2 if am.aff[ny, nx] == 1 else 3
            for lidx in range(2):
                if mm.map_refi[ny, nx][lidx] >= 0:
                    refi_l[cnt][lidx] = int(mm.map_refi[ny, nx][lidx])
                    cpmv[cnt][lidx] = derive_affine_model_mv(
                        mm, am, (y_scu, x_scu), (ny, nx), lidx, cuw, cuh,
                        cp_num[cnt], log2_max_cuwh)
                else:
                    refi_l[cnt][lidx] = REFI_INVALID
                    cpmv[cnt][lidx] = [[0, 0], [0, 0], [0, 0]]
            cnt += 1
        if cnt >= AFF_MODEL_CAND:
            break

    # ---- control-point based (constructed) ----
    cp_mv = [[[0, 0] for _ in range(VER_NUM)] for _ in range(2)]
    cp_refi = [[REFI_INVALID] * VER_NUM for _ in range(2)]
    cp_valid = [0] * VER_NUM

    def plain_ok(y, x):
        return _cod_ok(mm, y, x) and not bool(mm.map_ibc[y, x])

    # LT
    lt = [(y_scu - 1, x_scu - 1), (y_scu - 1, x_scu), (y_scu, x_scu - 1)]
    ltv = [x_scu > 0 and y_scu > 0 and plain_ok(*lt[0]),
           y_scu > 0 and plain_ok(*lt[1]),
           x_scu > 0 and plain_ok(*lt[2])]
    for k in range(3):
        if ltv[k]:
            p = lt[k]
            for lidx in range(2):
                cp_refi[lidx][0] = int(mm.map_refi[p][lidx])
                cp_mv[lidx][0] = [int(mm.map_mv[p][lidx][0]),
                                  int(mm.map_mv[p][lidx][1])]
            cp_valid[0] = 1
            break
    # RT
    rt = [(y_scu - 1, x_scu + scuw), (y_scu - 1, x_scu + scuw - 1),
          (y_scu, x_scu + scuw)]
    rtv = [y_scu > 0 and x_scu + scuw < w_scu and plain_ok(*rt[0]),
           y_scu > 0 and plain_ok(*rt[1]),
           x_scu + scuw < w_scu and plain_ok(*rt[2])]
    for k in range(3):
        if rtv[k]:
            p = rt[k]
            for lidx in range(2):
                cp_refi[lidx][1] = int(mm.map_refi[p][lidx])
                cp_mv[lidx][1] = [int(mm.map_mv[p][lidx][0]),
                                  int(mm.map_mv[p][lidx][1])]
            cp_valid[1] = 1
            break
    # LB: spatial when the left column is available, else TMVP
    if avail_lr in (LR_10, LR_11):
        lb = [(y_scu + scuh, x_scu - 1), (y_scu + scuh - 1, x_scu - 1)]
        lbv = [x_scu > 0 and y_scu + scuh < h_scu and plain_ok(*lb[0]),
               x_scu > 0 and plain_ok(*lb[1])]
        for k in range(2):
            if lbv[k]:
                p = lb[k]
                for lidx in range(2):
                    cp_refi[lidx][2] = int(mm.map_refi[p][lidx])
                    cp_mv[lidx][2] = [int(mm.map_mv[p][lidx][0]),
                                      int(mm.map_mv[p][lidx][1])]
                cp_valid[2] = 1
                break
    else:
        same_row = ((y_scu + scuh) << 2 >> log2_max_cuwh) == \
            (y_scu << 2 >> log2_max_cuwh)
        ok = x_scu > 0 and (y_scu + scuh < h_scu) and same_row
        if ok:
            py = ((y_scu + scuh) >> 1) << 1
            px = ((x_scu - 1) >> 1) << 1
            tmvp, avail = get_mv_collocated(refp, poc, (py, px),
                                            (y_scu, x_scu), mm, sh)
            if avail in (1, 3):
                cp_refi[0][2] = 0
                cp_mv[0][2] = list(tmvp[0])
            else:
                cp_refi[0][2] = REFI_INVALID
                cp_mv[0][2] = [0, 0]
            if avail in (2, 3) and slice_type == T.SLICE_B:
                cp_refi[1][2] = 0
                cp_mv[1][2] = list(tmvp[1])
            else:
                cp_refi[1][2] = REFI_INVALID
                cp_mv[1][2] = [0, 0]
        if cp_refi[0][2] >= 0 or cp_refi[1][2] >= 0:
            cp_valid[2] = 1
    # RB
    if avail_lr in (LR_01, LR_11):
        rb = [(y_scu + scuh, x_scu + scuw), (y_scu + scuh - 1, x_scu + scuw)]
        rbv = [x_scu + scuw < w_scu and y_scu + scuh < h_scu
               and plain_ok(*rb[0]),
               x_scu + scuw < w_scu and plain_ok(*rb[1])]
        for k in range(2):
            if rbv[k]:
                p = rb[k]
                for lidx in range(2):
                    cp_refi[lidx][3] = int(mm.map_refi[p][lidx])
                    cp_mv[lidx][3] = [int(mm.map_mv[p][lidx][0]),
                                      int(mm.map_mv[p][lidx][1])]
                break
    else:
        same_line = ((y_scu + scuh) << 2 >> log2_max_cuwh) == \
            (y_scu << 2 >> log2_max_cuwh)
        ok = x_scu + scuw < w_scu and y_scu + scuh < h_scu and same_line
        if ok:
            py = ((y_scu + scuh) >> 1) << 1
            px = ((x_scu + scuw) >> 1) << 1
            tmvp, avail = get_mv_collocated(refp, poc, (py, px),
                                            (y_scu, x_scu), mm, sh)
            if avail in (1, 3):
                cp_refi[0][3] = 0
                cp_mv[0][3] = list(tmvp[0])
            else:
                cp_refi[0][3] = REFI_INVALID
                cp_mv[0][3] = [0, 0]
            if avail in (2, 3) and slice_type == T.SLICE_B:
                cp_refi[1][3] = 0
                cp_mv[1][3] = list(tmvp[1])
            else:
                cp_refi[1][3] = REFI_INVALID
                cp_mv[1][3] = [0, 0]
    if cp_refi[0][3] >= 0 or cp_refi[1][3] >= 0:
        cp_valid[3] = 1

    const_model = [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3],
                   [0, 1], [0, 2]]
    cp_nums = [3, 3, 3, 3, 2, 2]
    for model_idx in range(6):
        if cnt >= AFF_MAX_CAND:
            break
        cnt = _constructed_candidate(
            cuw, cuh, cp_valid, cp_mv, cp_refi, const_model[model_idx],
            model_idx, cp_nums[model_idx], cpmv, refi_l, cnt, cp_num)

    # zero padding
    for k in range(cnt, AFF_MAX_CAND):
        cp_num[k] = 2
        for lidx in range(2):
            for v in range(2):
                cpmv[k][lidx][v] = [0, 0]
        refi_l[k][0] = 0
        refi_l[k][1] = 0 if slice_type == T.SLICE_B else REFI_INVALID
    return refi_l, cpmv, cp_num


def _constructed_candidate(cuw, cuh, cp_valid, cp_mv, cp_refi, cp_idx,
                           model_idx, ver_num, cpmv, refi_l, cnt, cp_num):
    """(ref: xevdm_derive_affine_constructed_candidate)"""
    if cnt >= AFF_MAX_CAND:
        return cnt
    shift_htow = 7 + int(T.TBL_LOG2[cuw]) - int(T.TBL_LOG2[cuh])
    valid_model = [0, 0]
    idxs = cp_idx[:ver_num]
    if any(not cp_valid[i] for i in idxs):
        return cnt
    for lidx in range(2):
        refs = [cp_refi[lidx][i] for i in idxs]
        if all(r >= 0 for r in refs) and all(r == refs[0] for r in refs):
            valid_model[lidx] = 1
    if not (valid_model[0] or valid_model[1]):
        return cnt
    cp_num[cnt] = ver_num
    for lidx in range(2):
        if valid_model[lidx]:
            refi_l[cnt][lidx] = cp_refi[lidx][idxs[0]]
            tmp = [[int(cp_mv[lidx][i][0]), int(cp_mv[lidx][i][1])]
                   for i in range(VER_NUM)]
            if model_idx == 1:    # LT, RT, RB -> derive LB
                tmp[2] = [tmp[3][0] + tmp[0][0] - tmp[1][0],
                          tmp[3][1] + tmp[0][1] - tmp[1][1]]
            elif model_idx == 2:  # LT, LB, RB -> derive RT
                tmp[1] = [tmp[3][0] + tmp[0][0] - tmp[2][0],
                          tmp[3][1] + tmp[0][1] - tmp[2][1]]
            elif model_idx == 3:  # RT, LB, RB -> derive LT
                tmp[0] = [tmp[1][0] + tmp[2][0] - tmp[3][0],
                          tmp[1][1] + tmp[2][1] - tmp[3][1]]
            elif model_idx == 5:  # LT, LB -> derive RT
                th = ((tmp[2][1] - tmp[0][1]) << shift_htow) \
                    + (tmp[0][0] << 7)
                tv = -((tmp[2][0] - tmp[0][0]) << shift_htow) \
                    + (tmp[0][1] << 7)
                h, v = mv_rounding(th, tv, 7, 0)
                tmp[1] = [h, v]
            for i in range(ver_num):
                cpmv[cnt][lidx][i] = [_s16c(tmp[i][0]), _s16c(tmp[i][1])]
        else:
            refi_l[cnt][lidx] = REFI_INVALID
            for i in range(ver_num):
                cpmv[cnt][lidx][i] = [0, 0]
    return cnt + 1


def get_affine_motion_scaling(poc, mm: MotionMaps, am: AffineMaps, x_scu,
                              y_scu, lidx, cur_refi, num_refp, refp, cuw,
                              cuh, vertex_num, log2_max_cuwh):
    """Affine AMVP: 2 candidates (ref: xevdm_get_affine_motion_scaling).
    Returns mvp[2][3][2]."""
    w_scu, h_scu = mm.w_scu, mm.h_scu
    scuw, scuh = cuw >> 2, cuh >> 2
    mvp = [[[0, 0], [0, 0], [0, 0]] for _ in range(AFF_MAX_NUM_MVP)]
    cnt_tmp = 0

    def aff_ok(y, x):
        return _cod_ok(mm, y, x) and am.aff[y, x] != 0

    def plain_ok(y, x):
        return _cod_ok(mm, y, x) and not bool(mm.map_ibc[y, x])

    # inherited: left {A0, A1}, above {B0, B1, B2}, right {C0, C1}
    groups = [
        [((y_scu + scuh, x_scu - 1),
          x_scu > 0 and y_scu + scuh < h_scu),
         ((y_scu + scuh - 1, x_scu - 1), x_scu > 0)],
        [((y_scu - 1, x_scu + scuw),
          y_scu > 0 and x_scu + scuw < w_scu),
         ((y_scu - 1, x_scu + scuw - 1), y_scu > 0),
         ((y_scu - 1, x_scu - 1), x_scu > 0 and y_scu > 0)],
        [((y_scu + scuh, x_scu + scuw),
          x_scu + scuw < w_scu and y_scu + scuh < h_scu),
         ((y_scu + scuh - 1, x_scu + scuw), x_scu + scuw < w_scu)],
    ]
    for grp in groups:
        for (p, cond) in grp:
            if cond and aff_ok(*p) and mm.map_refi[p][lidx] >= 0 and \
                    int(mm.map_refi[p][lidx]) == cur_refi:
                mvp[cnt_tmp] = derive_affine_model_mv(
                    mm, am, (y_scu, x_scu), p, lidx, cuw, cuh, vertex_num,
                    log2_max_cuwh)
                if len(mvp[cnt_tmp]) < 3:
                    mvp[cnt_tmp] = mvp[cnt_tmp] + [[0, 0]]
                cnt_tmp += 1
                break
        if cnt_tmp >= AFF_MAX_NUM_MVP:
            return mvp

    # corner translation candidates
    def corner_scan(cands):
        for (p, cond) in cands:
            if cond and plain_ok(*p) and mm.map_refi[p][lidx] >= 0:
                if int(mm.map_refi[p][lidx]) == cur_refi:
                    return [int(mm.map_mv[p][lidx][0]),
                            int(mm.map_mv[p][lidx][1])]
        return None

    lt = corner_scan([((y_scu - 1, x_scu - 1), x_scu > 0 and y_scu > 0),
                      ((y_scu - 1, x_scu), y_scu > 0),
                      ((y_scu, x_scu - 1), x_scu > 0)])
    rt = corner_scan([((y_scu - 1, x_scu + scuw),
                       y_scu > 0 and x_scu + scuw < w_scu),
                      ((y_scu - 1, x_scu + scuw - 1), y_scu > 0),
                      ((y_scu, x_scu + scuw), x_scu + scuw < w_scu)])
    lb = corner_scan([((y_scu + scuh, x_scu - 1),
                       x_scu > 0 and y_scu + scuh < h_scu),
                      ((y_scu + scuh - 1, x_scu - 1), x_scu > 0)])
    rb = corner_scan([((y_scu + scuh, x_scu + scuw),
                       x_scu + scuw < w_scu and y_scu + scuh < h_scu),
                      ((y_scu + scuh - 1, x_scu + scuw),
                       x_scu + scuw < w_scu)])

    if lt is not None and rt is not None and \
            (vertex_num == 2 or (lb is not None or rb is not None)):
        mvp[cnt_tmp][0] = list(lt)
        mvp[cnt_tmp][1] = list(rt)
        mvp[cnt_tmp][2] = list(lb) if lb is not None else [0, 0]
        if lb is None and rb is not None:
            mvp[cnt_tmp][2] = [_s16c(rb[0] + lt[0] - rt[0]),
                               _s16c(rb[1] + lt[1] - rt[1])]
        cnt_tmp += 1
    if cnt_tmp == AFF_MAX_NUM_MVP:
        return mvp
    if lb is not None:
        mvp[cnt_tmp] = [list(lb), list(lb), list(lb)]
        cnt_tmp += 1
    elif rb is not None:
        mvp[cnt_tmp] = [list(rb), list(rb), list(rb)]
        cnt_tmp += 1
    if cnt_tmp == AFF_MAX_NUM_MVP:
        return mvp
    if rt is not None:
        mvp[cnt_tmp] = [list(rt), list(rt), list(rt)]
        cnt_tmp += 1
    if cnt_tmp == AFF_MAX_NUM_MVP:
        return mvp
    if lt is not None:
        mvp[cnt_tmp] = [list(lt), list(lt), list(lt)]
        cnt_tmp += 1
    # zero fill (already zeros)
    return mvp


def set_affine_mvf(mm: MotionMaps, x_scu, y_scu, log2w, log2h, refi,
                   ac_mv2, vertex_num):
    """Write the affine sub-block motion field into the SCU maps
    (ref: xevdm_set_affine_mvf)."""
    w_cu = (1 << log2w) >> 2
    h_cu = (1 << log2h) >> 2
    sub_w, sub_h, _ = derive_affine_subblock_size_bi(
        ac_mv2, refi, 1 << log2w, 1 << log2h, vertex_num)
    sub_w_scu, sub_h_scu = sub_w >> 2, sub_h >> 2
    half_w, half_h = sub_w >> 1, sub_h >> 1
    for lidx in range(2):
        if refi[lidx] < 0:
            continue
        ac_mv = ac_mv2[lidx]
        dmv_hor_x = (ac_mv[1][0] - ac_mv[0][0]) << (7 - log2w)
        dmv_hor_y = (ac_mv[1][1] - ac_mv[0][1]) << (7 - log2w)
        if vertex_num == 3:
            dmv_ver_x = (ac_mv[2][0] - ac_mv[0][0]) << (7 - log2h)
            dmv_ver_y = (ac_mv[2][1] - ac_mv[0][1]) << (7 - log2h)
        else:
            dmv_ver_x = -dmv_hor_y
            dmv_ver_y = dmv_hor_x
        mv_scale_hor = ac_mv[0][0] << 7
        mv_scale_ver = ac_mv[0][1] << 7
        for h in range(0, h_cu, sub_h_scu):
            for w in range(0, w_cu, sub_w_scu):
                if w == 0 and h == 0:
                    th, tv = ac_mv[0][0], ac_mv[0][1]
                elif w + sub_w_scu == w_cu and h == 0:
                    th, tv = ac_mv[1][0], ac_mv[1][1]
                elif w == 0 and h + sub_h_scu == h_cu and vertex_num == 3:
                    th, tv = ac_mv[2][0], ac_mv[2][1]
                else:
                    pos_x = (w << 2) + half_w
                    pos_y = (h << 2) + half_h
                    th = mv_scale_hor + dmv_hor_x * pos_x \
                        + dmv_ver_x * pos_y
                    tv = mv_scale_ver + dmv_hor_y * pos_x \
                        + dmv_ver_y * pos_y
                    th, tv = mv_rounding(th, tv, 5, 0)
                    th = max(-(1 << 17), min((1 << 17) - 1, th))
                    tv = max(-(1 << 17), min((1 << 17) - 1, tv))
                    th >>= 2
                    tv >>= 2
                mm.map_mv[y_scu + h:y_scu + h + sub_h_scu,
                          x_scu + w:x_scu + w + sub_w_scu, lidx, 0] = th
                mm.map_mv[y_scu + h:y_scu + h + sub_h_scu,
                          x_scu + w:x_scu + w + sub_w_scu, lidx, 1] = tv
    for lidx in range(2):
        mm.map_refi[y_scu:y_scu + h_cu, x_scu:x_scu + w_cu, lidx] = \
            refi[lidx]
    return sub_w, sub_h


def affine_center_mv(ac_mv2, refi, log2w, log2h, vertex_num):
    """Center sub-block MV for the HMVP history entry
    (ref: src_main/xevdm.c:657-800 update_history_buffer_parse_affine).
    Returns (refi_sp[2], mv_sp[2][2], any_valid)."""
    refi_sp = [REFI_INVALID, REFI_INVALID]
    mv_sp = [[0, 0], [0, 0]]
    for lidx in range(2):
        if refi[lidx] < 0:
            continue
        ac_mv = ac_mv2[lidx]
        dmv_hor_x = (ac_mv[1][0] - ac_mv[0][0]) << (7 - log2w)
        dmv_hor_y = (ac_mv[1][1] - ac_mv[0][1]) << (7 - log2w)
        if vertex_num == 3:
            dmv_ver_x = (ac_mv[2][0] - ac_mv[0][0]) << (7 - log2h)
            dmv_ver_y = (ac_mv[2][1] - ac_mv[0][1]) << (7 - log2h)
        else:
            dmv_ver_x = -dmv_hor_y
            dmv_ver_y = dmv_hor_x
        pos_x = 1 << (log2w - 1)
        pos_y = 1 << (log2h - 1)
        th = (ac_mv[0][0] << 7) + dmv_hor_x * pos_x + dmv_ver_x * pos_y
        tv = (ac_mv[0][1] << 7) + dmv_hor_y * pos_x + dmv_ver_y * pos_y
        th, tv = mv_rounding(th, tv, 7, 0)
        mv_sp[lidx] = [max(-(1 << 15), min((1 << 15) - 1, th)),
                       max(-(1 << 15), min((1 << 15) - 1, tv))]
        refi_sp[lidx] = refi[lidx]
    any_valid = refi_sp[0] >= 0 or refi_sp[1] >= 0
    return refi_sp, mv_sp, any_valid
