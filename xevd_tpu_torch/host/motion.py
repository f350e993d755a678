"""ADMVP motion derivation: merge candidate lists, HMVP history,
AMVR-aware MVP, temporal collocated MVs.

This is the Main profile's advanced motion toolbox
(ref: src_main/xevdm_util.c:594-1405 candidate machinery,
src_main/xevdm.c:655-1010 recon-side selection + history updates).
All functions are pure over a `MotionMaps` snapshot so the decoder's
derive pass and the test-stream generator share one implementation.
"""
from __future__ import annotations

import numpy as np

from . import tables as T

MAXM_NUM_MVP = 6
MAX_NUM_MVP_SMALL_CU = 4
NUM_SAMPLES_BLOCK = 32
ALLOWED_CHECKED_NUM = 23
ALLOWED_CHECKED_NUM_SMALL_CU = 15
ALLOWED_CHECKED_AMVP_NUM = 4
MVP_SCALING_PRECISION = 5
LR_00, LR_10, LR_01, LR_11 = 0, 1, 2, 3
REFI_INVALID = -1
BI_NON, BI_NORMAL, BI_FL0, BI_FL1 = 0, 1, 2, 3


def _s16c(v):
    return max(-(1 << 15), min((1 << 15) - 1, int(v)))


def c_div(a, b):
    """C-style truncating integer division."""
    a, b = int(a), int(b)
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def scaling_mv(ratio, mv):
    """(ref: src_main/xevdm_util.c scaling_mv)"""
    out = [0, 0]
    for d in range(2):
        t = int(mv[d]) * ratio
        if t == 0:
            v = 0
        elif t > 0:
            v = (t + (1 << (MVP_SCALING_PRECISION - 1))) >> \
                MVP_SCALING_PRECISION
        else:
            v = -((-t + (1 << (MVP_SCALING_PRECISION - 1))) >>
                  MVP_SCALING_PRECISION)
        out[d] = _s16c(v)
    return out


class MotionMaps:
    """Decode-time SCU-map snapshot consumed by candidate derivation."""

    def __init__(self, w_scu, h_scu):
        self.w_scu = w_scu
        self.h_scu = h_scu
        self.map_mv = np.zeros((h_scu, w_scu, 2, 2), dtype=np.int16)
        # refined-MV view: aliases map_mv unless DMVR is active (then a
        # separate array carrying refined sub-PU MVs for DMVR CUs; the
        # MMVD base list reads it -- xevdm_get_mmvd_mvp_list takes
        # ctx->map_mv with NO unrefined fallback, ref: xevdm_util.c:4697)
        self.map_mv_ref = self.map_mv
        self.map_refi = np.full((h_scu, w_scu, 2), REFI_INVALID,
                                dtype=np.int8)
        self.cod = np.zeros((h_scu, w_scu), dtype=np.uint8)
        self.map_if = np.zeros((h_scu, w_scu), dtype=np.uint8)
        self.map_ibc = np.zeros((h_scu, w_scu), dtype=np.uint8)
        # HMVP history: fixed table + count (the reference keeps stale
        # entries when an affine center MV is invalid -- currCnt still
        # increments / the shifted tail keeps its old value, ref:
        # src_main/xevdm.c:657-800)
        self.hist_refi = [[REFI_INVALID, REFI_INVALID]
                          for _ in range(ALLOWED_CHECKED_NUM)]
        self.hist_mv = [[[0, 0], [0, 0]] for _ in range(ALLOWED_CHECKED_NUM)]
        self.hist_cnt = 0

    @property
    def history(self):
        # newest-last view of the live entries (legacy accessor)
        return [(self.hist_refi[i], self.hist_mv[i])
                for i in range(self.hist_cnt)]

    def history_reset(self):
        # per-CTU-row reset clears only the count; table contents persist
        # (ref: xevdm_hmvp_init resets currCnt)
        self.hist_cnt = 0

    # -- HMVP (ref: src_main/xevdm.c:657-798) ---------------------------
    def history_update(self, refi, mv, valid=True):
        ent_refi = [int(refi[0]), int(refi[1])]
        ent_mv = [[int(mv[0][0]), int(mv[0][1])],
                  [int(mv[1][0]), int(mv[1][1])]]
        if self.hist_cnt == ALLOWED_CHECKED_NUM:
            for i in range(1, self.hist_cnt):
                self.hist_refi[i - 1] = self.hist_refi[i]
                self.hist_mv[i - 1] = self.hist_mv[i]
            if valid:
                self.hist_refi[self.hist_cnt - 1] = ent_refi
                self.hist_mv[self.hist_cnt - 1] = ent_mv
        else:
            if valid:
                self.hist_refi[self.hist_cnt] = ent_refi
                self.hist_mv[self.hist_cnt] = ent_mv
            self.hist_cnt += 1

    def avail_lr(self, x_scu, y_scu, scuw):
        """(ref: src_base/xevd_util.c:1156-1174 xevd_check_nev_avail)"""
        lr = 0
        if x_scu > 0 and self.cod[y_scu, x_scu - 1]:
            lr += 1
        if x_scu + scuw < self.w_scu and self.cod[y_scu, x_scu + scuw]:
            lr += 2
        return lr


def check_motion_availability(mm: MotionMaps, x_scu, y_scu, scuw, scuh,
                              avail_lr, is_ibc=False):
    """5-position neighbor scan (ref: src_main/xevdm_util.c:594-744).
    Returns (neb[(y,x)*5], valid[5])."""
    w_scu, h_scu = mm.w_scu, mm.h_scu

    def ok(y, x):
        if not mm.cod[y, x]:
            return False
        if is_ibc:
            return bool(mm.map_ibc[y, x])
        return not mm.map_if[y, x] and not mm.map_ibc[y, x]

    yb = y_scu + scuh - 1
    if avail_lr == LR_11:
        neb = [(yb, x_scu - 1), (yb, x_scu + scuw), (y_scu - 1, x_scu),
               (y_scu - 1, x_scu + scuw), (y_scu - 1, x_scu - 1)]
        valid = [x_scu > 0 and ok(*neb[0]),
                 x_scu + scuw < w_scu and ok(*neb[1]),
                 y_scu > 0 and ok(*neb[2]),
                 y_scu > 0 and x_scu + scuw < w_scu and ok(*neb[3]),
                 x_scu > 0 and y_scu > 0 and ok(*neb[4])]
    elif avail_lr == LR_01:
        neb = [(yb, x_scu + scuw), (y_scu - 1, x_scu),
               (y_scu - 1, x_scu - 1), (y_scu + scuh, x_scu + scuw),
               (y_scu - 1, x_scu + scuw)]
        valid = [x_scu + scuw < w_scu and ok(*neb[0]),
                 y_scu > 0 and ok(*neb[1]),
                 y_scu > 0 and x_scu > 0 and ok(*neb[2]),
                 y_scu + scuh < h_scu and x_scu + scuw < w_scu
                 and ok(*neb[3]),
                 y_scu > 0 and x_scu + scuw < w_scu and ok(*neb[4])]
    else:
        neb = [(yb, x_scu - 1), (y_scu - 1, x_scu + scuw - 1),
               (y_scu - 1, x_scu + scuw), (y_scu + scuh, x_scu - 1),
               (y_scu - 1, x_scu - 1)]
        valid = [x_scu > 0 and ok(*neb[0]),
                 y_scu > 0 and ok(*neb[1]),
                 y_scu > 0 and x_scu + scuw < w_scu and ok(*neb[2]),
                 y_scu + scuh < h_scu and x_scu > 0 and ok(*neb[3]),
                 y_scu > 0 and x_scu > 0 and ok(*neb[4])]
    return neb, valid


def _merge_insert(refi_l, mvp_l, cnt, src_refi, src_mv, slice_type,
                  cuw, cuh):
    """(ref: src_main/xevdm_util.c xevdm_get_merge_insert_mv)"""
    refi_l[0][cnt] = src_refi[0] if src_refi[0] >= 0 else REFI_INVALID
    mvp_l[0][cnt] = [int(src_mv[0][0]), int(src_mv[0][1])]
    if slice_type == T.SLICE_B:
        if src_refi[0] < 0:
            refi_l[1][cnt] = src_refi[1] if src_refi[1] >= 0 else REFI_INVALID
            mvp_l[1][cnt] = [int(src_mv[1][0]), int(src_mv[1][1])]
        elif not check_bi_applicability(slice_type, cuw, cuh):
            refi_l[1][cnt] = REFI_INVALID
            mvp_l[1][cnt] = [0, 0]
        else:
            refi_l[1][cnt] = src_refi[1] if src_refi[1] >= 0 else REFI_INVALID
            mvp_l[1][cnt] = [int(src_mv[1][0]), int(src_mv[1][1])]


def _check_redundancy(slice_type, mvp_l, refi_l, cnt):
    """(ref: src_main/xevdm_util.c check_redundancy)"""
    if cnt > 0:
        for i in range(cnt - 1, -1, -1):
            if refi_l[0][cnt] == refi_l[0][i] and \
                    mvp_l[0][cnt] == mvp_l[0][i]:
                if slice_type != T.SLICE_B or (
                        refi_l[1][cnt] == refi_l[1][i]
                        and mvp_l[1][cnt] == mvp_l[1][i]):
                    return cnt - 1
    return cnt


def check_bi_applicability(slice_type, cuw, cuh, is_sps_admvp=1):
    if slice_type != T.SLICE_B:
        return False
    return (not is_sps_admvp) or (cuw + cuh > 12)


def clip_mv_pic(x, y, max_x, max_y, mvp):
    """(ref: src_main/xevdm_util.c:1417-1429)"""
    lo = -T.PIC_PAD_SIZE_L
    for l in range(2):
        if x + mvp[l][0] < lo:
            mvp[l][0] = -(x + lo)
        if y + mvp[l][1] < lo:
            mvp[l][1] = -(y + lo)
        if x + mvp[l][0] > max_x:
            mvp[l][0] = max_x - x
        if y + mvp[l][1] > max_y:
            mvp[l][1] = max_y - y


def get_mv_collocated(refp, poc, scup_yx, c_scup_yx, mm: MotionMaps, sh):
    """Temporal MV from the collocated picture
    (ref: src_main/xevdm_util.c:3729-3820).  Returns (mvp[2][2], avail_idx)."""
    mvp = [[0, 0], [0, 0]]
    tmvp_assigned = sh.temporal_mvp_asigned_flag
    if tmvp_assigned:
        col_list = sh.collocated_from_list_idx
        col_ref = sh.collocated_from_ref_idx
        col_src_list = sh.collocated_mvp_source_list_idx
    else:
        col_list = 0 if sh.slice_type == T.SLICE_P else 1
        col_ref = 0
        col_src_list = 0
    col = refp[col_ref][col_list]
    if col is None:
        return mvp, 0
    y, x = scup_yx
    ver_refi = [-1, -1]
    dpoc = [poc - refp[0][0].poc if refp[0][0] else 0,
            poc - refp[0][1].poc if refp[0][1] else 0]
    if not tmvp_assigned:
        for lidx in range(2):
            refidx = int(col.map_refi[y, x, lidx])
            if refidx >= 0:
                dpoc_co = int(col.poc) - int(col.list_poc[refidx])
                if dpoc_co != 0:
                    ratio = c_div(dpoc[lidx] << MVP_SCALING_PRECISION,
                                  dpoc_co)
                    ver_refi[lidx] = 0
                    mvp[lidx] = scaling_mv(ratio, col.map_mv[y, x, lidx])
    else:
        refidx = int(col.map_refi[y, x, col_src_list])
        dpoc_co = 0
        if refidx >= 0:
            dpoc_co = int(col.poc) - int(col.list_poc[refidx])
        if dpoc_co != 0:
            ver_refi = [0, 0]
            mvc = col.map_mv[y, x, col_src_list]
            mvp[0] = scaling_mv(
                c_div(dpoc[0] << MVP_SCALING_PRECISION, dpoc_co), mvc)
            mvp[1] = scaling_mv(
                c_div(dpoc[1] << MVP_SCALING_PRECISION, dpoc_co), mvc)
    cy, cx = c_scup_yx
    max_x = T.PIC_PAD_SIZE_L + (mm.w_scu << 2) - 1
    max_y = T.PIC_PAD_SIZE_L + (mm.h_scu << 2) - 1
    clip_mv_pic(cx << 2, cy << 2, max_x, max_y, mvp)
    avail = (1 if ver_refi[0] >= 0 else 0) + (2 if ver_refi[1] >= 0 else 0)
    return mvp, avail


def _right_below_scup_merge(x_scu, y_scu, scuw, scuh, w_scu, h_scu,
                            bottom_right, log2_ctu, suco):
    """(ref: src_main/xevdm_util.c:1001-1057)"""
    if suco:
        xb = x_scu - 1
        yb = y_scu + scuh - 1
        if bottom_right == 0:
            if yb + 1 >= h_scu:
                return None
            if ((yb + 1) << 2 >> log2_ctu) != (yb << 2 >> log2_ctu):
                return None
            return (((yb + 1) >> 1) << 1, ((xb + 1) >> 1) << 1)
        if xb < 0:
            return None
        if ((xb + 1) << 2 >> log2_ctu) != (xb << 2 >> log2_ctu):
            return None
        return ((yb >> 1) << 1, (xb >> 1) << 1)
    xb = x_scu + scuw - 1
    yb = y_scu + scuh - 1
    if bottom_right == 0:
        if yb + 1 >= h_scu:
            return None
        if ((yb + 1) << 2 >> log2_ctu) != (yb << 2 >> log2_ctu):
            return None
        return (((yb + 1) >> 1) << 1, (xb >> 1) << 1)
    if xb + 1 >= w_scu:
        return None
    if ((xb + 1) << 2 >> log2_ctu) != (xb << 2 >> log2_ctu):
        return None
    return ((yb >> 1) << 1, ((xb + 1) >> 1) << 1)


def get_motion_merge_main(poc, slice_type, mm: MotionMaps, refp, x_scu,
                          y_scu, cuw, cuh, avail_lr, sh, log2_ctu,
                          use_refined=False):
    """Merge candidate list (ref: src_main/xevdm_util.c:1169-1405).
    Returns (refi[2][N], mvp[2][N][2]) with N = MAXM_NUM_MVP.
    use_refined: read the refined-MV view for spatial neighbors -- the
    MMVD base list does (xevdm_get_mmvd_mvp_list gets ctx->map_mv with
    no DMVRF fallback); plain merge uses unrefined for DMVR CUs
    (ref: xevdm_util.c:1212)."""
    scuw, scuh = cuw >> 2, cuh >> 2
    small_cu = cuw * cuh <= NUM_SAMPLES_BLOCK
    max_cand = MAX_NUM_MVP_SMALL_CU if small_cu else MAXM_NUM_MVP
    refi_l = [[REFI_INVALID] * MAXM_NUM_MVP for _ in range(2)]
    mvp_l = [[[0, 0] for _ in range(MAXM_NUM_MVP)] for _ in range(2)]
    cnt = 0

    mv_map = mm.map_mv_ref if use_refined else mm.map_mv
    neb, valid = check_motion_availability(mm, x_scu, y_scu, scuw, scuh,
                                           avail_lr)
    for k in range(5):
        if valid[k]:
            p = neb[k]
            _merge_insert(refi_l, mvp_l, cnt, mm.map_refi[p], mv_map[p],
                          slice_type, cuw, cuh)
            cnt = _check_redundancy(slice_type, mvp_l, refi_l, cnt)
            cnt += 1
        if cnt == max_cand - 1:
            break

    def add_tmvp(scup_yx):
        nonlocal cnt
        tmvp, avail = get_mv_collocated(refp, poc, scup_yx, (y_scu, x_scu),
                                        mm, sh)
        if avail == 0:
            return False
        refs = [0 if avail in (1, 3) else -1, 0 if avail in (2, 3) else -1]
        before = cnt
        _merge_insert(refi_l, mvp_l, cnt, refs, tmvp, slice_type, cuw, cuh)
        cnt = _check_redundancy(slice_type, mvp_l, refi_l, cnt)
        cnt += 1
        return cnt == before + 1

    # TMVP: central 8x8-aligned position, then bottom, then right
    done = False
    if not done:
        scu_col = (((y_scu + (scuh >> 1)) >> 1) << 1,
                   ((x_scu + (scuw >> 1)) >> 1) << 1)
        done = add_tmvp(scu_col)
        if cnt >= max_cand:
            return refi_l, mvp_l
    suco = avail_lr == LR_01
    if not done:
        p = _right_below_scup_merge(x_scu, y_scu, scuw, scuh, mm.w_scu,
                                    mm.h_scu, 0, log2_ctu, suco)
        if p is not None:
            done = add_tmvp(p)
            if cnt >= max_cand:
                return refi_l, mvp_l
    if not done:
        p = _right_below_scup_merge(x_scu, y_scu, scuw, scuh, mm.w_scu,
                                    mm.h_scu, 1, log2_ctu, suco)
        if p is not None:
            done = add_tmvp(p)
            if cnt >= max_cand:
                return refi_l, mvp_l

    # HMVP candidates, every 4th entry from the newest-3 back
    if cnt < max_cand:
        lim = min(len(mm.history),
                  ALLOWED_CHECKED_NUM_SMALL_CU if small_cu
                  else ALLOWED_CHECKED_NUM)
        k = 3
        while k <= lim:
            h_refi, h_mv = mm.history[len(mm.history) - k]
            _merge_insert(refi_l, mvp_l, cnt, h_refi, h_mv, slice_type,
                          cuw, cuh)
            cnt = _check_redundancy(slice_type, mvp_l, refi_l, cnt)
            cnt += 1
            if cnt >= max_cand:
                return refi_l, mvp_l
            k += 4

    # pairwise L0/L1 combinations
    if check_bi_applicability(slice_type, cuw, cuh):
        pri0 = [0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3, 0, 4, 1, 4, 2, 4, 3, 4]
        pri1 = [1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2, 4, 0, 4, 1, 4, 2, 4, 3]
        cur = cnt
        i = 0
        while i < cur * (cur - 1) and cnt != max_cand:
            i0, i1 = pri0[i], pri1[i]
            if refi_l[0][i0] >= 0 and refi_l[1][i1] >= 0:
                refi_l[0][cnt] = refi_l[0][i0]
                mvp_l[0][cnt] = list(mvp_l[0][i0])
                refi_l[1][cnt] = refi_l[1][i1]
                mvp_l[1][cnt] = list(mvp_l[1][i1])
                cnt += 1
            i += 1
        if cnt == max_cand:
            return refi_l, mvp_l

    bi_ok = check_bi_applicability(slice_type, cuw, cuh)
    for k in range(cnt, max_cand):
        refi_l[0][k] = 0
        mvp_l[0][k] = [0, 0]
        refi_l[1][k] = 0 if bi_ok else REFI_INVALID
        mvp_l[1][k] = [0, 0]
    return refi_l, mvp_l


def get_default_motion(mm: MotionMaps, neb, valid, cur_refi, lidx,
                       hmvp_flag):
    """(ref: src_main/xevdm_util.c:771-868)"""
    refi = 0
    mv = [0, 0]
    found = False
    for k in range(2):
        if valid[k]:
            p = neb[k]
            t = int(mm.map_refi[p][lidx])
            if t == cur_refi:
                found = True
                refi = t
                mv = [int(mm.map_mv[p][lidx][0]), int(mm.map_mv[p][lidx][1])]
                break
    if not found:
        for k in range(2):
            if valid[k]:
                p = neb[k]
                t = int(mm.map_refi[p][lidx])
                if t >= 0:
                    found = True
                    refi = t
                    mv = [int(mm.map_mv[p][lidx][0]),
                          int(mm.map_mv[p][lidx][1])]
                    break
    if hmvp_flag:
        if not found:
            for k in range(1, min(len(mm.history),
                                  ALLOWED_CHECKED_AMVP_NUM) + 1):
                h_refi, h_mv = mm.history[len(mm.history) - k]
                if h_refi[lidx] == cur_refi:
                    found = True
                    refi = h_refi[lidx]
                    mv = list(h_mv[lidx])
                    break
        if not found:
            for k in range(1, min(len(mm.history),
                                  ALLOWED_CHECKED_AMVP_NUM) + 1):
                h_refi, h_mv = mm.history[len(mm.history) - k]
                if h_refi[lidx] >= 0:
                    found = True
                    refi = h_refi[lidx]
                    mv = list(h_mv[lidx])
                    break
    return refi, mv


def get_motion_from_mvr(mvr_idx, poc, mm: MotionMaps, x_scu, y_scu, lidx,
                        cur_refi, num_refp, refp, cuw, cuh, avail_lr,
                        hmvp_flag):
    """AMVR-aware single-MVP derivation
    (ref: src_main/xevdm_util.c:869-1000).  Returns mvp[2]."""
    scuw, scuh = cuw >> 2, cuh >> 2
    rounding = (1 << (mvr_idx - 1)) if mvr_idx > 0 else 0
    neb, valid = check_motion_availability(mm, x_scu, y_scu, scuw, scuh,
                                           avail_lr)
    default_refi, default_mv = get_default_motion(mm, neb, valid, cur_refi,
                                                  lidx, hmvp_flag)
    poc_refi_cur = refp[cur_refi][lidx].poc
    ratio = [0] * num_refp
    for i in range(num_refp):
        t0 = poc - refp[i][lidx].poc
        ratio[i] = c_div((poc - poc_refi_cur) << MVP_SCALING_PRECISION, t0)
    if valid[mvr_idx]:
        p = neb[mvr_idx]
        refi0 = int(mm.map_refi[p][lidx])
        if refi0 == cur_refi:
            mvp_t = [int(mm.map_mv[p][lidx][0]), int(mm.map_mv[p][lidx][1])]
        elif refi0 < 0:
            refi0 = default_refi
            if refi0 == cur_refi:
                mvp_t = list(default_mv)
            else:
                mvp_t = scaling_mv(ratio[refi0], default_mv)
        else:
            mvp_t = scaling_mv(ratio[refi0], mm.map_mv[p][lidx])
    else:
        refi0 = default_refi
        if refi0 == cur_refi:
            mvp_t = list(default_mv)
        else:
            mvp_t = scaling_mv(ratio[refi0], default_mv)
    out = [0, 0]
    for d in range(2):
        v = mvp_t[d]
        out[d] = (((v + rounding) >> mvr_idx) << mvr_idx) if v >= 0 \
            else -(((-v + rounding) >> mvr_idx) << mvr_idx)
    return out


def get_first_refi(mm: MotionMaps, x_scu, y_scu, cuw, cuh, lidx, mvr_idx,
                   avail_lr, hmvp_flag):
    """Reference index for FL bi modes (ref: src_main/xevdm_util.c:745-770)."""
    neb, valid = check_motion_availability(
        mm, x_scu, y_scu, cuw >> 2, cuh >> 2, avail_lr)
    default_refi, _ = get_default_motion(mm, neb, valid, 0, lidx, hmvp_flag)
    if valid[mvr_idx]:
        p = neb[mvr_idx]
        t = int(mm.map_refi[p][lidx])
        return t if t >= 0 else default_refi
    return default_refi


MMVD_BASE_MV_NUM = 4
MMVD_MAX_REFINE_NUM = 32
MMVD_REF_CANDS = [1, 2, 4, 8, 16, 32, 64, 128]


def get_mmvd_motion(mmvd_idx, poc, slice_type, mm: MotionMaps, refp,
                    num_refp, x_scu, y_scu, cuw, cuh, avail_lr, sh,
                    log2_ctu):
    """MMVD motion for one parsed index: merge-base + scaled refinement
    (ref: src_main/xevdm_util.c:192-593, selection :4682-4717).
    Returns (refi[2], mv[2][2])."""
    group = mmvd_idx >> 7
    base_idx = (mmvd_idx & 127) >> 5
    kref = mmvd_idx & 31
    small_cu = cuw * cuh <= NUM_SAMPLES_BLOCK

    refi_l, mvp_l = get_motion_merge_main(poc, slice_type, mm, refp, x_scu,
                                          y_scu, cuw, cuh, avail_lr, sh,
                                          log2_ctu, use_refined=True)
    REF_SET = [[refp[i][l].poc if (i < len(refp) and refp[i][l] is not None)
                else 0 for i in range(5)] for l in range(2)]

    if slice_type == T.SLICE_B:
        base = [[mvp_l[0][base_idx][0], mvp_l[0][base_idx][1],
                 refi_l[0][base_idx]],
                [mvp_l[1][base_idx][0], mvp_l[1][base_idx][1],
                 refi_l[1][base_idx]]]
    else:
        base = [[mvp_l[0][base_idx][0], mvp_l[0][base_idx][1],
                 refi_l[0][base_idx]],
                [mvp_l[1][0][0], mvp_l[1][0][1], refi_l[1][0]]]

    bt = [list(b) for b in base]          # base_mv_t
    base_p = [[0, 0, 0] for _ in range(3)]
    r0, r1 = bt[0][2], bt[1][2]
    ref_sign = ref_sign1 = 1
    prec = MVP_SCALING_PRECISION

    def scale_abs(weight, v, sign):
        return _s16c(sign * ((abs(weight * v) + (1 << (prec - 1))) >> prec))

    if r0 >= 0 and r1 >= 0:
        base_type = [0, 1, 2]
    elif r0 >= 0 and r1 < 0:
        if slice_type == T.SLICE_P:
            base_type = [1, 1, 1]
            nref = num_refp[0]
            if nref == 1:
                base_p[0] = [bt[0][0], bt[0][1], bt[0][2]]
                base_p[1] = [bt[0][0] + 3, bt[0][1], bt[0][2]]
                base_p[2] = [bt[0][0] - 3, bt[0][1], bt[0][2]]
            else:
                ref_b0 = bt[0][2]
                ref_b1 = 0 if bt[0][2] else 1
                if nref < 3:
                    ref_b2 = bt[0][2]
                else:
                    ref_b2 = 2 if bt[0][2] < 2 else 1
                base_p[0] = [bt[0][0], bt[0][1], ref_b0]
                w1 = c_div((poc - REF_SET[0][ref_b0]) << prec,
                           poc - REF_SET[0][ref_b1])
                base_p[1] = [scale_abs(w1, bt[0][0], 1),
                             scale_abs(w1, bt[0][1], 1), ref_b1]
                if nref == 2:
                    base_p[2] = [bt[0][0] - 3, bt[0][1], ref_b2]
                else:
                    w2 = c_div((poc - REF_SET[0][ref_b0]) << prec,
                               poc - REF_SET[0][ref_b2])
                    base_p[2] = [scale_abs(w2, bt[0][0], 1),
                                 scale_abs(w2, bt[0][1], 1), ref_b2]
        else:
            base_type = [1, 0, 2]
            poc0 = REF_SET[0][r0]
            if num_refp[1] > 1 and (REF_SET[1][1] - poc) == (poc - poc0):
                bt[1][2] = 1
            else:
                bt[1][2] = 0
            poc1 = REF_SET[1][bt[1][2]]
            w = c_div((poc - poc1) << prec, poc - poc0)
            if w * bt[0][0] < 0:
                ref_sign = -1
            bt[1][0] = scale_abs(w, bt[0][0], ref_sign)
            if w * bt[0][1] < 0:
                ref_sign1 = -1
            bt[1][1] = scale_abs(w, bt[0][1], ref_sign1)
    elif r0 < 0 and r1 >= 0:
        base_type = [2, 0, 1]
        poc1 = REF_SET[1][r1]
        if num_refp[0] > 1 and (REF_SET[0][1] - poc) == (poc - poc1):
            bt[0][2] = 1
        else:
            bt[0][2] = 0
        poc0 = REF_SET[0][bt[0][2]]
        w = c_div((poc - poc0) << prec, poc - poc1)
        if w * bt[1][0] < 0:
            ref_sign = -1
        bt[0][0] = scale_abs(w, bt[1][0], ref_sign)
        if w * bt[1][1] < 0:
            ref_sign1 = -1
        bt[0][1] = scale_abs(w, bt[1][1], ref_sign1)
    else:
        base_type = [3, 3, 3]

    if small_cu:
        base_type[0] = 1

    # NB: for one-sided types the reference leaves the other list's MV at
    # its original merge-candidate value (not the mirrored one); that stale
    # value flows into maps/history and later redundancy checks.
    t = base_type[group]
    if t == 0:
        bm = [list(bt[0]), list(bt[1])]
    elif t == 1:
        if slice_type == T.SLICE_P:
            bm = [[base_p[group][0], base_p[group][1], base_p[group][2]],
                  [base[1][0], base[1][1], -1]]
        else:
            bm = [list(bt[0]), [base[1][0], base[1][1], -1]]
    elif t == 2:
        bm = [[base[0][0], base[0][1], -1], list(bt[1])]
    else:
        bm = [[base[0][0], base[0][1], -1], [base[1][0], base[1][1], -1]]

    l0r, l1r = bm[0][2], bm[1][2]
    ref_sign = 1
    if slice_type == T.SLICE_B and l0r != -1 and l1r != -1:
        poc0, poc1 = REF_SET[0][l0r], REF_SET[1][l1r]
        if (poc0 - poc) * (poc - poc1) > 0:
            ref_sign = -1

    cand = MMVD_REF_CANDS[kref >> 2]
    ref_mvd = ref_mvd1 = cand
    if l0r != -1 and l1r != -1:
        poc0, poc1 = REF_SET[0][l0r], REF_SET[1][l1r]
        if abs(poc1 - poc) >= abs(poc0 - poc):
            w = c_div(abs(poc0 - poc) << prec, abs(poc1 - poc))
            ref_mvd = _s16c((w * cand + (1 << (prec - 1))) >> prec)
        else:
            w = c_div(abs(poc1 - poc) << prec, abs(poc0 - poc))
            ref_mvd1 = _s16c((w * cand + (1 << (prec - 1))) >> prec)

    km = kref & 3
    if km == 0:
        h0, h1, v0, v1 = ref_mvd, ref_mvd1 * ref_sign, 0, 0
    elif km == 1:
        h0, h1, v0, v1 = -ref_mvd, -ref_mvd1 * ref_sign, 0, 0
    elif km == 2:
        h0, h1, v0, v1 = 0, 0, ref_mvd, ref_mvd1 * ref_sign
    else:
        h0, h1, v0, v1 = 0, 0, -ref_mvd, -ref_mvd1 * ref_sign

    mv = [[bm[0][0] + h0, bm[0][1] + v0], [bm[1][0] + h1, bm[1][1] + v1]]
    refi = [bm[0][2], bm[1][2]]
    if slice_type == T.SLICE_P:
        refi[1] = REFI_INVALID
    return refi, mv
