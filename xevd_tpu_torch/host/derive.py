"""Host derivation pass: motion reconstruction, intra availability masks and
deblock boundary strengths.

Runs after the entropy pass in decode order.  This replaces the scalar
per-CU derivations interleaved with reconstruction in the reference
(ref: src_base/xevd.c:477-565 motion, src_base/xevd_util.c:632-745
availability, src_base/xevd_df.c:34-94 strengths) with a host pass that
emits batched tensors for the device pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import tables as T
from .frame import FrameSyntax

AVAIL_UP = 1
AVAIL_LE = 2
AVAIL_UP_RI = 4
AVAIL_UP_LE = 8


@dataclass
class FrameJob:
    """Everything the pixel pipeline needs for one frame."""
    fs: FrameSyntax
    bit_depth: int
    chroma_format_idc: int
    # final per-CU motion (after MVP+mvd / skip / direct derivation)
    cu_mv: np.ndarray = None        # int32 [N, 2, 2] quarter-pel
    cu_refi: np.ndarray = None      # int32 [N, 2]
    # per-SCU final motion field (stored with the picture for TMVP)
    map_mv: np.ndarray = None       # int16 [h_scu, w_scu, 2, 2]
    map_refi: np.ndarray = None     # int8 [h_scu, w_scu, 2]
    # intra neighbor availability, per CU: bitmask over units
    cu_nbr_up: np.ndarray = None    # int64 [N] bitmask (scuw+scuh units)
    cu_nbr_left: np.ndarray = None  # int64 [N]
    cu_nbr_corner: np.ndarray = None  # uint8 [N]
    # Main-profile extras (ref: src_main/xevdm_ipred.c:39-148)
    cu_nbr_upext: np.ndarray = None  # int64 [N] up-left extension (scuh bits)
    cu_nbr_right: np.ndarray = None  # int64 [N] right column (scuw+scuh bits)
    cu_avail_lr: np.ndarray = None   # uint8 [N] LR availability (recon-time)
    # deblock strengths (0 == no filtering)
    db_hor_y: np.ndarray = None     # int32 [h_scu, w_scu]
    db_hor_u: np.ndarray = None
    db_hor_v: np.ndarray = None
    db_ver_y: np.ndarray = None
    db_ver_u: np.ndarray = None
    db_ver_v: np.ndarray = None
    # ADDB parameter maps (Main, tool_addb): dir 0 = ver edges, 1 = hor
    addb_luma: np.ndarray = None    # int32 [2, h_scu, w_scu, 4] bs,a,b,c1
    addb_chroma: np.ndarray = None  # int32 [2, h_scu, w_scu, 7]
    #                                  bs, a_u, b_u, c0_u, a_v, b_v, c0_v
    # HTDF (Main, tool_htdf), per CU: LUT row (-1 = skip) + recon-time
    # availability bits (ops/htdf.py HT_*)
    cu_htdf_idx: np.ndarray = None  # int32 [N]
    cu_htdf_avail: np.ndarray = None  # int32 [N]
    # affine (Main, tool_affine): per-CU control-point MVs
    cu_aff_flag: np.ndarray = None  # int32 [N]: 0 off, 1 = 4-param, 2 = 6
    cu_aff_mv: np.ndarray = None    # int32 [N, 2, 3, 2] CPMVs
    # ALF (Main, tool_alf): set by the decoder when sh.alf_on
    alf_param: object = None        # aps.AlfSliceParam (effective)
    alf_enable: tuple = None        # (luma, u, v)
    alf_misc: tuple = None          # (log2_ctu, across_tiles)
    poc: int = 0                    # current POC (DMVR symmetry check)
    tool_dmvr: bool = False
    # DMVR (tool_dmvr): per-CU refined sub-PU MVs, computed during derive
    # (the refined top-left value feeds HMVP in-frame, ref:
    # xevdm_util.c:4385-4389 core->mv reload + xevdm.c history update)
    dmvr_mvs: dict = None           # cu index -> int32 [n_sy, n_sx, 2, 2]
    map_ibc: object = None          # uint8 [h_scu, w_scu] IBC-coded cells


def derive_frame(fs: FrameSyntax, sps, pps, sh, refp, poc_val,
                 chroma_qp_tbl, num_refp=(0, 0), log2_ctu=6) -> FrameJob:
    """Decode-order host pass (ref: recon-phase logic of src_base/xevd.c)."""
    from .motion import (MotionMaps, get_first_refi, get_motion_from_mvr,
                         get_motion_merge_main)
    job = FrameJob(fs=fs, bit_depth=sps.bit_depth_luma_minus8 + 8,
                   chroma_format_idc=sps.chroma_format_idc)
    job.poc = int(poc_val)
    job.tool_dmvr = bool(getattr(sps, "is_main", False)
                         and getattr(sps, "tool_dmvr", 0))
    h_scu, w_scu = fs.h_scu, fs.w_scu
    n = fs.num_cus()

    mm = MotionMaps(w_scu, h_scu)
    mm.map_if = fs.map_if
    map_mv = mm.map_mv
    if job.tool_dmvr:
        # separate refined-MV view (DMVR CUs carry refined sub-PU MVs;
        # the MMVD base list and the stored/TMVP map read it)
        mm.map_mv_ref = mm.map_mv.copy()
    map_mv_ref = mm.map_mv_ref
    track_ref = map_mv_ref is not map_mv
    map_refi = mm.map_refi
    cod = mm.cod
    is_main_sps = getattr(sps, "is_main", False)
    use_admvp = bool(is_main_sps and sps.tool_admvp)
    hmvp = bool(is_main_sps and sps.tool_hmvp)

    cu_mv = np.zeros((n, 2, 2), dtype=np.int32)
    cu_refi = np.full((n, 2), T.REFI_INVALID, dtype=np.int32)
    nbr_up = np.zeros(n, dtype=np.int64)
    nbr_left = np.zeros(n, dtype=np.int64)
    nbr_corner = np.zeros(n, dtype=np.uint8)
    nbr_upext = np.zeros(n, dtype=np.int64)
    nbr_right = np.zeros(n, dtype=np.int64)
    avail_lr = np.zeros(n, dtype=np.uint8)
    is_main = getattr(sps, "is_main", False)
    htdf_on = bool(is_main and sps.tool_htdf)
    if htdf_on:
        from .ops import htdf as HT
        if pps.constrained_intra_pred_flag:
            from .syntax import UnsupportedStream
            raise UnsupportedStream(
                "HTDF with constrained intra prediction unsupported")
    cu_htdf_idx = np.full(n, -1, dtype=np.int32)
    cu_htdf_avail = np.zeros(n, dtype=np.int32)
    affine_on = bool(is_main and getattr(sps, "tool_affine", 0))
    cu_aff_flag = np.zeros(n, dtype=np.int32)
    cu_aff_mv = np.zeros((n, 2, 3, 2), dtype=np.int32)
    if affine_on:
        from . import affine as AF
        am = AF.AffineMaps(w_scu, h_scu)
    else:
        am = None

    map_if = fs.map_if
    constrained = pps.constrained_intra_pred_flag

    cur_ctu_row = -1
    for i in range(n):
        x, y = fs.cu_x[i], fs.cu_y[i]
        cuw = 1 << fs.cu_log2w[i]
        cuh = 1 << fs.cu_log2h[i]
        if hmvp:
            # HMVP history resets at the start of every CTU row
            # (ref: src_main/xevdm.c:2497-2501)
            row = y >> log2_ctu
            if row != cur_ctu_row:
                cur_ctu_row = row
                mm.history_reset()
        x_scu, y_scu = x >> 2, y >> 2
        scuw = cuw >> 2
        scuh = cuh >> 2
        pm = fs.cu_pred_mode[i]
        dmvr_ref_q = None

        if pm == T.MODE_INTRA:
            # neighbor availability per 4-sample unit
            # (ref: src_base/xevd_ipred.c:33-93, xevd_util.c:689-745)
            n_units = scuw + scuh
            up_mask = 0
            if y_scu > 0:
                for u in range(n_units):
                    xs = x_scu + u
                    if xs < w_scu and cod[y_scu - 1, xs] and (
                            not constrained or map_if[y_scu - 1, xs]):
                        up_mask |= 1 << u
            left_mask = 0
            if x_scu > 0:
                for u in range(n_units):
                    ysu = y_scu + u
                    if ysu < h_scu and cod[ysu, x_scu - 1] and (
                            not constrained or map_if[ysu, x_scu - 1]):
                        left_mask |= 1 << u
            corner = 0
            if x_scu > 0 and y_scu > 0 and cod[y_scu - 1, x_scu - 1] and (
                    not constrained or map_if[y_scu - 1, x_scu - 1]):
                corner = 1
            nbr_up[i] = up_mask
            nbr_left[i] = left_mask
            nbr_corner[i] = corner
            if is_main:
                # up-left extension + right column
                # (ref: src_main/xevdm_ipred.c:78-92,127-145)
                upext = 0
                if y_scu > 0 and x_scu > 0:
                    for u in range(scuh):
                        xs = x_scu - 1 - u
                        if xs >= 0 and cod[y_scu - 1, xs] and (
                                not constrained or map_if[y_scu - 1, xs]):
                            upext |= 1 << u
                right = 0
                if x_scu + scuw < w_scu:
                    for u in range(n_units):
                        ysu = y_scu + u
                        if ysu < h_scu and cod[ysu, x_scu + scuw] and (
                                not constrained or map_if[ysu, x_scu + scuw]):
                            right |= 1 << u
                nbr_upext[i] = upext
                nbr_right[i] = right
                # recon-time LR availability
                # (ref: src_base/xevd_util.c:1156-1174)
                lr = 0
                if x_scu > 0 and cod[y_scu, x_scu - 1]:
                    lr += 1
                if x_scu + scuw < w_scu and cod[y_scu, x_scu + scuw]:
                    lr += 2
                avail_lr[i] = lr
            # intra: zero motion, invalid refs (already defaults)
            ys_, xs_ = slice(y_scu, y_scu + scuh), slice(x_scu, x_scu + scuw)
            map_refi[ys_, xs_] = T.REFI_INVALID
            map_mv[ys_, xs_] = 0
        else:
            avail = _avail_inter(cod, map_if, x_scu, y_scu, scuw, scuh,
                                 w_scu, h_scu)
            refi_parsed = fs.cu_refi[i]
            mvp_idx = fs.cu_mvp_idx[i]
            inter_dir = fs.cu_inter_dir[i]
            mv = np.zeros((2, 2), dtype=np.int64)
            refi = [T.REFI_INVALID, T.REFI_INVALID]
            scup = (y_scu, x_scu)

            aff = int(fs.cu_aff[i]) if affine_on else 0
            if pm == T.MODE_IBC:
                # block copy: the raw mvd is the block vector
                # (ref: src_main/xevdm_eco.c:1789-1800, set_dec_info)
                mv[0] = fs.cu_mvd[i][0]
                refi = [T.REFI_INVALID, T.REFI_INVALID]
                mm.map_ibc[y_scu:y_scu + scuh, x_scu:x_scu + scuw] = 1
            elif aff and pm in (T.MODE_SKIP, T.MODE_DIR):
                # affine merge (ref: src_main/xevdm.c:946-977)
                lr = mm.avail_lr(x_scu, y_scu, scuw)
                refi_l, cpmv_l, cp_num = AF.get_affine_merge_candidate(
                    poc_val, fs.slice_type, mm, am, refp, x_scu, y_scu,
                    cuw, cuh, lr, sh, log2_ctu)
                mrg = int(fs.cu_mvp_idx[i][0])
                vertex = cp_num[mrg]
                aff = vertex - 1
                ac_mv2 = [[list(v) for v in cpmv_l[mrg][l]]
                          for l in range(2)]
                refi = [refi_l[mrg][0], refi_l[mrg][1]]
                for l in range(2):
                    if refi[l] < 0:
                        ac_mv2[l] = [[0, 0], [0, 0], [0, 0]]
            elif aff and pm == T.MODE_INTER:
                # affine AMVP (ref: src_main/xevdm.c:978-1021)
                vertex = aff + 1
                ac_mv2 = [[[0, 0], [0, 0], [0, 0]] for _ in range(2)]
                for lidx in range(2):
                    if ((inter_dir + 1) >> lidx) & 1:
                        refi[lidx] = int(refi_parsed[lidx])
                        mvp_a = AF.get_affine_motion_scaling(
                            poc_val, mm, am, x_scu, y_scu, lidx,
                            refi[lidx], num_refp[lidx], refp, cuw, cuh,
                            vertex, log2_ctu)
                        mp = [list(v) for v in mvp_a[int(fs.cu_mvp_idx[i][lidx])]]
                        amvd = fs.cu_aff_mvd[i][lidx]
                        # CPMV0's mvd propagates into the other
                        # predictors (ref: src_main/xevdm.c:995-1004)
                        for v in range(vertex):
                            mvd0x = int(amvd[0][0]) if v > 0 else 0
                            mvd0y = int(amvd[0][1]) if v > 0 else 0
                            ac_mv2[lidx][v] = [
                                _s16(mp[v][0] + mvd0x + int(amvd[v][0])),
                                _s16(mp[v][1] + mvd0y + int(amvd[v][1]))]
                    else:
                        refi[lidx] = T.REFI_INVALID
            elif use_admvp and pm in (T.MODE_SKIP, T.MODE_DIR):
                # merge list / MMVD (ref: src_main/xevdm.c:800-886)
                lr = mm.avail_lr(x_scu, y_scu, scuw)
                if fs.cu_mmvd_flag[i]:
                    from .motion import get_mmvd_motion
                    refi, mv2 = get_mmvd_motion(
                        fs.cu_mmvd_idx[i], poc_val, fs.slice_type, mm,
                        refp, num_refp, x_scu, y_scu, cuw, cuh, lr, sh,
                        log2_ctu)
                    mv[0] = mv2[0]
                    mv[1] = mv2[1]
                    if fs.slice_type == T.SLICE_P:
                        refi[1] = T.REFI_INVALID
                        mv[1] = 0
                else:
                    refi_l, mvp_l = get_motion_merge_main(
                        poc_val, fs.slice_type, mm, refp, x_scu, y_scu,
                        cuw, cuh, lr, sh, log2_ctu)
                    idx0 = mvp_idx[0]
                    refi = [refi_l[0][idx0], refi_l[1][idx0]]
                    mv[0] = mvp_l[0][idx0]
                    mv[1] = mvp_l[1][idx0]
                    if fs.slice_type == T.SLICE_P:
                        refi[1] = T.REFI_INVALID
                        mv[1] = 0
            elif use_admvp:
                # AMVR-aware MVP + mvd (ref: src_main/xevdm.c:887-1000)
                lr = mm.avail_lr(x_scu, y_scu, scuw)
                mvr = fs.cu_mvr_idx[i]
                bi = fs.cu_bi_idx[i]
                for lidx in range(2):
                    if ((inter_dir + 1) >> lidx) & 1:
                        if bi in (2, 3):  # BI_FL0/BI_FL1: refi inferred
                            refi[lidx] = get_first_refi(
                                mm, x_scu, y_scu, cuw, cuh, lidx, mvr, lr,
                                hmvp)
                        else:
                            refi[lidx] = refi_parsed[lidx]
                        mvp0 = get_motion_from_mvr(
                            mvr, poc_val, mm, x_scu, y_scu, lidx,
                            refi[lidx], num_refp[lidx], refp, cuw, cuh,
                            lr, hmvp)
                        mvd = fs.cu_mvd[i][lidx]
                        if bi == 2 + lidx:
                            mvd = (0, 0)
                        mv[lidx, 0] = _s16(mvp0[0] + (mvd[0] << mvr))
                        mv[lidx, 1] = _s16(mvp0[1] + (mvd[1] << mvr))
                    else:
                        refi[lidx] = T.REFI_INVALID
                        mv[lidx] = 0
            elif pm == T.MODE_SKIP:
                # (ref: src_base/xevd.c:507-538)
                lists = (0, 1) if fs.slice_type == T.SLICE_B else (0,)
                for lidx in lists:
                    mvp = _mvp_candidates(map_mv, refp, scup, lidx, scuw,
                                          w_scu, avail)
                    mv[lidx] = mvp[mvp_idx[lidx]]
                    refi[lidx] = 0
                if fs.slice_type == T.SLICE_P:
                    refi[1] = T.REFI_INVALID
                    mv[1] = 0
            elif inter_dir == T.PRED_DIR:
                # temporal direct (ref: src_base/xevd.c:715-720,
                # src_base/xevd_util.c:540-566)
                scup_co = (y_scu + scuh - 1, x_scu + scuw - 1)
                mv0, mv1 = _mv_dir(refp, poc_val, scup_co)
                mv[0] = mv0
                mv[1] = mv1
                refi = [0, 0]
            else:
                for lidx in range(2):
                    if ((inter_dir + 1) >> lidx) & 1:
                        mvp = _mvp_candidates(map_mv, refp, scup, lidx, scuw,
                                              w_scu, avail)
                        mvd = fs.cu_mvd[i][lidx]
                        mv[lidx, 0] = _s16(mvp[mvp_idx[lidx]][0] + mvd[0])
                        mv[lidx, 1] = _s16(mvp[mvp_idx[lidx]][1] + mvd[1])
                        refi[lidx] = refi_parsed[lidx]
                    else:
                        refi[lidx] = T.REFI_INVALID
                        mv[lidx] = 0

            if job.tool_dmvr and not aff and pm in (T.MODE_SKIP, T.MODE_DIR) \
                    and not fs.cu_mmvd_flag[i]:
                from .ops.dmvr import dmvr_condition, dmvr_refine_cu
                if dmvr_condition(sps, poc_val, refp,
                                  [int(refi[0]), int(refi[1])], mv,
                                  int(cuw), int(cuh)):
                    dmvr_ref_q = dmvr_refine_cu(
                        int(fs.cu_x[i]), int(fs.cu_y[i]), fs.w, fs.h,
                        int(cuw), int(cuh),
                        [int(refi[0]), int(refi[1])],
                        [[int(mv[0][0]), int(mv[0][1])],
                         [int(mv[1][0]), int(mv[1][1])]],
                        refp, sps.bit_depth_luma_minus8 + 8)
                    if job.dmvr_mvs is None:
                        job.dmvr_mvs = {}
                    job.dmvr_mvs[i] = dmvr_ref_q
            if aff:
                lw_, lh_ = int(fs.cu_log2w[i]), int(fs.cu_log2h[i])
                AF.set_affine_mvf(mm, x_scu, y_scu, lw_, lh_, refi,
                                  ac_mv2, vertex)
                if hmvp:
                    refi_sp, mv_sp, any_valid = AF.affine_center_mv(
                        ac_mv2, refi, lw_, lh_, vertex)
                    mm.history_update(refi_sp, mv_sp, valid=any_valid)
                cu_aff_flag[i] = vertex - 1
                for l in range(2):
                    for v in range(3):
                        cu_aff_mv[i, l, v] = ac_mv2[l][v]
                cu_refi[i] = refi
            else:
                if hmvp and pm != T.MODE_IBC:
                    # DMVR CUs push the REFINED top-left sub-PU MV: the
                    # reference reloads core->mv from the refined map
                    # before the history update (ref: xevdm_util.c
                    # :4385-4389)
                    if dmvr_ref_q is not None:
                        mm.history_update(refi, dmvr_ref_q[0, 0] >> 2)
                    else:
                        mm.history_update(refi, mv)

                cu_mv[i] = mv
                cu_refi[i] = refi
                ys_, xs_ = slice(y_scu, y_scu + scuh), slice(x_scu, x_scu + scuw)
                map_refi[ys_, xs_, 0] = refi[0]
                map_refi[ys_, xs_, 1] = refi[1]
                map_mv[ys_, xs_] = mv.astype(np.int16)
            if am is not None:
                am.set_cu(x_scu, y_scu, scuw, scuh, cu_aff_flag[i]
                          if aff else 0, int(fs.cu_log2w[i]),
                          int(fs.cu_log2h[i]))

        if htdf_on and fs.cu_tree[i] != 2 and pm != T.MODE_IBC and (
                pm == T.MODE_INTRA or fs.cu_cbf[i][0]):
            # HTDF skip condition + LUT row (slice qp) and recon-time
            # availability (ref: src_main/xevdm.c:1383-1390,
            # src_base/xevd_util.c:689-745)
            idx = T.htdf_skip_and_idx(cuw, cuh, pm == T.MODE_INTRA, sh.qp)
            if idx >= 0:
                cu_htdf_idx[i] = idx
                av = 0
                if x_scu > 0 and cod[y_scu, x_scu - 1]:
                    av |= HT.HT_LE
                    if y_scu + scuh + scuw - 1 < h_scu and \
                            cod[y_scu + scuw + scuh - 1, x_scu - 1]:
                        av |= HT.HT_LO_LE
                if y_scu > 0:
                    av |= HT.HT_UP
                    if x_scu > 0 and cod[y_scu - 1, x_scu - 1]:
                        av |= HT.HT_UP_LE
                    if x_scu + scuw < w_scu and cod[y_scu - 1, x_scu + scuw]:
                        av |= HT.HT_UP_RI
                if x_scu + scuw < w_scu and cod[y_scu, x_scu + scuw]:
                    av |= HT.HT_RI
                    if y_scu + scuh + scuw - 1 < h_scu and \
                            cod[y_scu + scuw + scuh - 1, x_scu + scuw]:
                        av |= HT.HT_LO_RI
                cu_htdf_avail[i] = av

        cod[y_scu:y_scu + scuh, x_scu:x_scu + scuw] = 1
        if track_ref:
            ys_, xs_ = slice(y_scu, y_scu + scuh), slice(x_scu, x_scu + scuw)
            if dmvr_ref_q is None:
                map_mv_ref[ys_, xs_] = map_mv[ys_, xs_]
            else:
                dys = min(int(cuh), 16) >> 2
                dxs = min(int(cuw), 16) >> 2
                for sj in range(dmvr_ref_q.shape[0]):
                    for si in range(dmvr_ref_q.shape[1]):
                        map_mv_ref[y_scu + sj * dys:y_scu + (sj + 1) * dys,
                                   x_scu + si * dxs:x_scu + (si + 1) * dxs] \
                            = (dmvr_ref_q[sj, si] >> 2).astype(np.int16)

    job.cu_htdf_idx = cu_htdf_idx
    job.cu_htdf_avail = cu_htdf_avail
    job.cu_aff_flag = cu_aff_flag
    job.cu_aff_mv = cu_aff_mv
    job.cu_mv = cu_mv
    job.cu_refi = cu_refi
    job.map_mv = map_mv
    job.map_ibc = mm.map_ibc
    job.map_refi = map_refi
    job.cu_nbr_up = nbr_up
    job.cu_nbr_left = nbr_left
    job.cu_nbr_corner = nbr_corner
    job.cu_nbr_upext = nbr_upext
    job.cu_nbr_right = nbr_right
    job.cu_avail_lr = avail_lr

    if sh.deblocking_filter_on:
        if is_main_sps and sps.tool_addb:
            _addb_params(job, fs, sps, sh, chroma_qp_tbl, refp, log2_ctu)
        else:
            _deblock_strengths(job, fs, sps, sh, chroma_qp_tbl)
    if job.db_hor_y is None:
        z = np.zeros((h_scu, w_scu), dtype=np.int32)
        job.db_hor_y = job.db_hor_u = job.db_hor_v = z
        job.db_ver_y = job.db_ver_u = job.db_ver_v = z
    if track_ref:
        # stored motion field = refined view (TMVP of later frames);
        # spatial merge/deblock above consumed the unrefined values
        # (ref: map_unrefined_mv / MCU_DMVRF)
        map_mv[:] = map_mv_ref
    return job


def job_from_native(fs: FrameSyntax, sps, sh, chroma_qp_tbl,
                    native_job) -> FrameJob:
    """Assemble a FrameJob from the native C derive pass outputs
    (native/evc_entropy.c derive_cu) + the vectorized strength derivation."""
    job = FrameJob(fs=fs, bit_depth=sps.bit_depth_luma_minus8 + 8,
                   chroma_format_idc=sps.chroma_format_idc)
    job.cu_mv = native_job["cu_mv"]
    job.cu_refi = native_job["cu_refi"]
    job.map_mv = native_job["map_mv"]
    job.map_refi = native_job["map_refi"]
    job.cu_nbr_up = native_job["nbr_up"]
    job.cu_nbr_left = native_job["nbr_left"]
    job.cu_nbr_corner = native_job["nbr_corner"]
    if sh.deblocking_filter_on:
        from .native import deblock_strengths_native
        tbl_u, tbl_v = native_job["chroma_qp_tbl"]
        hy, hu, hv, vy, vu, vv = deblock_strengths_native(
            fs, sps, sh, tbl_u, tbl_v, job.map_refi, job.map_mv)
        job.db_hor_y, job.db_hor_u, job.db_hor_v = hy, hu, hv
        job.db_ver_y, job.db_ver_u, job.db_ver_v = vy, vu, vv
    else:
        z = np.zeros((fs.h_scu, fs.w_scu), dtype=np.int32)
        job.db_hor_y = job.db_hor_u = job.db_hor_v = z
        job.db_ver_y = job.db_ver_u = job.db_ver_v = z
    return job


def _s16(v):
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def _avail_inter(cod, map_if, x_scu, y_scu, scuw, scuh, w_scu, h_scu):
    """(ref: src_base/xevd_util.c:632-687)"""
    avail = 0
    if x_scu > 0 and not map_if[y_scu, x_scu - 1] and cod[y_scu, x_scu - 1]:
        avail |= AVAIL_LE
    if y_scu > 0:
        if not map_if[y_scu - 1, x_scu]:
            avail |= AVAIL_UP
        if x_scu + scuw < w_scu and cod[y_scu - 1, x_scu + scuw] and \
                not map_if[y_scu - 1, x_scu + scuw]:
            avail |= AVAIL_UP_RI
    return avail


def _mvp_candidates(map_mv, refp, scup, lidx, scuw, w_scu, avail):
    """4 baseline MVP candidates (ref: src_base/xevd_util.c:469-515)."""
    y_scu, x_scu = scup
    mvp = np.ones((T.MAX_NUM_MVP, 2), dtype=np.int64)
    if avail & AVAIL_LE:
        mvp[0] = map_mv[y_scu, x_scu - 1, lidx]
    if avail & AVAIL_UP:
        mvp[1] = map_mv[y_scu - 1, x_scu, lidx]
    if avail & AVAIL_UP_RI:
        mvp[2] = map_mv[y_scu - 1, x_scu + scuw, lidx]
    ref0 = refp[0][lidx] if refp[0][lidx] is not None else None
    if ref0 is not None:
        mvp[3] = ref0.map_mv[y_scu, x_scu, 0]
    else:
        mvp[3] = 0
    return mvp


def _mv_dir(refp, poc, scup_co):
    """Temporal direct MV scaling (ref: src_base/xevd_util.c:540-566)."""
    r1 = refp[0][1]
    y, x = scup_co
    mvc = r1.map_mv[y, x, 0].astype(np.int64)
    dpoc_co = r1.poc - r1.list_poc[0]
    dpoc_l0 = poc - refp[0][0].poc
    dpoc_l1 = r1.poc - poc
    if dpoc_co == 0:
        return np.zeros(2, np.int64), np.zeros(2, np.int64)
    mv0 = _cdiv_trunc(dpoc_l0 * mvc, dpoc_co)
    mv1 = _cdiv_trunc(-dpoc_l1 * mvc, dpoc_co)
    return mv0, mv1


def _cdiv_trunc(a, b):
    """C-style truncating division, elementwise."""
    q = np.abs(a) // abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _deblock_strengths(job: FrameJob, fs: FrameSyntax, sps, sh, chroma_qp_tbl):
    """Vectorized boundary-strength derivation
    (ref: src_base/xevd_df.c:34-94,291-545)."""
    h_scu, w_scu = fs.h_scu, fs.w_scu
    bd_l = sps.bit_depth_luma_minus8
    bd_c = sps.bit_depth_chroma_minus8
    map_if = fs.map_if.astype(bool)
    cbfl = fs.map_cbfl.astype(bool)
    refi = job.map_refi.astype(np.int32)
    mv = job.map_mv.astype(np.int32)

    def table_idx(cur, nb):
        """idx per SCU pair; cur/nb are index tuples into the SCU maps."""
        if_any = map_if[cur] | map_if[nb]
        cbf_any = cbfl[cur] | cbfl[nb]
        r0, r1 = refi[cur], refi[nb]  # [...,2]
        m0 = mv[cur].copy()
        m1 = mv[nb].copy()
        m0[r0 < 0] = 0
        m1[r1 < 0] = 0
        same_order = (r0[..., 0] == r1[..., 0]) & (r0[..., 1] == r1[..., 1])
        cross_order = (r0[..., 0] == r1[..., 1]) & (r0[..., 1] == r1[..., 0])
        big_same = (np.abs(m0 - m1).reshape(m0.shape[0], -1) >= 4).any(-1)
        m1x = m1[..., ::-1, :]
        big_cross = (np.abs(m0 - m1x).reshape(m0.shape[0], -1) >= 4).any(-1)
        idx = np.where(same_order, np.where(big_same, 2, 3),
                       np.where(cross_order, np.where(big_cross, 2, 3), 2))
        if job.map_ibc is not None:
            ibc_any = job.map_ibc.astype(bool)[cur] \
                | job.map_ibc.astype(bool)[nb]
            idx = np.where(ibc_any, 2, idx)     # (ref: xevdm_df.c:52-55)
        idx = np.where(cbf_any, 1, idx)
        idx = np.where(if_any, 0, idx)
        return idx

    qp_off = 6 * bd_c
    qp_tab_u = chroma_qp_tbl[0]
    qp_tab_v = chroma_qp_tbl[1]

    def strengths(idx, qp):
        st_y = T.DF_ST[idx, qp] << bd_l
        qp_u = np.clip(qp + sh.qp_u_offset, -qp_off, 57)
        qp_v = np.clip(qp + sh.qp_v_offset, -qp_off, 57)
        st_u = T.DF_ST[idx, qp_tab_u[qp_u + qp_off]] << bd_c
        st_v = T.DF_ST[idx, qp_tab_v[qp_v + qp_off]] << bd_c
        return st_y, st_u, st_v

    # Chroma edges gate on the chroma-carrying unit map (differs from the
    # luma map inside local-dual-tree areas; TREE_L leaf edges deblock luma
    # only — ref: src_main/xevdm.c deblock_tree dispatch).  Baseline/native
    # paths have no dual tree and leave the chroma maps unset.
    edge_hor_c = fs.edge_hor_c if fs.edge_hor_c is not None else fs.edge_hor
    edge_ver_c = fs.edge_ver_c if fs.edge_ver_c is not None else fs.edge_ver

    def edge_pass(edge, edge_c, nb_of):
        """One direction: luma strengths at `edge` cells, chroma at
        `edge_c` cells (same cells unless local dual tree made them
        differ — then a second chroma-only pass runs)."""
        sy = np.zeros((h_scu, w_scu), np.int32)
        su = np.zeros_like(sy)
        sv = np.zeros_like(sy)
        same = edge_c is edge or np.array_equal(edge_c, edge)
        ys, xs = np.nonzero(edge)
        sel = nb_of(ys, xs)
        ys, xs = ys[sel[0]], xs[sel[0]]
        if len(ys):
            idx = table_idx((ys, xs), sel[1](ys, xs))
            qp = fs.map_qp[ys, xs]
            st_y, st_u, st_v = strengths(idx, qp)
            sy[ys, xs] = st_y
            if same:
                su[ys, xs] = st_u
                sv[ys, xs] = st_v
        if not same:
            ys, xs = np.nonzero(edge_c)
            sel = nb_of(ys, xs)
            ys, xs = ys[sel[0]], xs[sel[0]]
            if len(ys):
                idx = table_idx((ys, xs), sel[1](ys, xs))
                qp = fs.map_qp[ys, xs]
                _, st_u, st_v = strengths(idx, qp)
                su[ys, xs] = st_u
                sv[ys, xs] = st_v
        return sy, su, sv

    # horizontal edges (top edge of CU): pair (cur=(y,x), up=(y-1,x))
    hy, hu, hv = edge_pass(
        fs.edge_hor, edge_hor_c,
        lambda ys, xs: (ys > 0, lambda ys, xs: (ys - 1, xs)))
    # vertical edges (left edge of CU): pair (cur=(y,x), left=(y,x-1));
    # parameters come from the right-side block in both driver branches
    vy, vu, vv = edge_pass(
        fs.edge_ver, edge_ver_c,
        lambda ys, xs: (xs > 0, lambda ys, xs: (ys, xs - 1)))

    job.db_hor_y, job.db_hor_u, job.db_hor_v = hy, hu, hv
    job.db_ver_y, job.db_ver_u, job.db_ver_v = vy, vu, vv


def _addb_params(job: FrameJob, fs: FrameSyntax, sps, sh, chroma_qp_tbl,
                 refp, log2_ctu):
    """Vectorized ADDB boundary-strength + threshold derivation
    (ref: src_main/xevdm_df.c:361-513 get_bs, :835-1135 drivers).

    Emits per-SCU-cell parameter maps for the 8x8-grid-aligned CU-boundary
    edges; dir 0 = vertical (left) edges, dir 1 = horizontal (top) edges.
    A cell with bs == 0 is not filtered, so the maps double as the edge
    gating.  Luma edges gate on the luma CU-edge maps, chroma on the
    chroma-carrying-unit maps (local dual tree)."""
    h_scu, w_scu = fs.h_scu, fs.w_scu
    bd_l = sps.bit_depth_luma_minus8 + 8
    bd_c = sps.bit_depth_chroma_minus8 + 8
    map_if = fs.map_if.astype(bool)
    cbfl = fs.map_cbfl.astype(bool)
    map_ats = fs.map_ats.astype(bool)
    refi = job.map_refi.astype(np.int32)
    mv = job.map_mv.astype(np.int32)
    alpha_off = sh.sh_deblock_alpha_offset & 0xFF  # u8 arg in ref get_index
    beta_off = sh.sh_deblock_beta_offset & 0xFF

    # picture-identity table per (lidx, refi): get_bs compares the actual
    # reference PICTURES (ref :422-426), not indices
    max_ref = max(int(refi.max()) + 1, 1)
    pid = np.full((2, max_ref), -1, np.int64)
    ids = {}
    for lidx in range(2):
        for r in range(max_ref):
            try:
                pic = refp[r][lidx].pic
            except (IndexError, AttributeError):
                continue
            if pic is None:
                continue
            pid[lidx, r] = ids.setdefault(id(pic), len(ids))

    def get_bs(cur, nb, cross_lcu):
        if_any = map_if[cur] | map_if[nb]
        ats_any = map_ats[cur] | map_ats[nb]
        cbf_any = cbfl[cur] | cbfl[nb]
        r0 = refi[cur]                      # [M, 2]
        r1 = refi[nb]
        v0 = r0 >= 0
        v1 = r1 >= 0
        p0 = np.stack([
            np.where(v0[:, 0], pid[0][np.maximum(r0[:, 0], 0)], -1),
            np.where(v0[:, 1], pid[1][np.maximum(r0[:, 1], 0)], -1)], 1)
        p1 = np.stack([
            np.where(v1[:, 0], pid[0][np.maximum(r1[:, 0], 0)], -1),
            np.where(v1[:, 1], pid[1][np.maximum(r1[:, 1], 0)], -1)], 1)
        m0 = mv[cur].copy()                 # [M, 2, 2]
        m1 = mv[nb].copy()
        m0[~v0] = 0
        m1[~v1] = 0

        def cmp(a, b):                      # |d| < 4 both components
            return (np.abs(a[:, 0] - b[:, 0]) < 4) & \
                   (np.abs(a[:, 1] - b[:, 1]) < 4)

        same_direct = (p0[:, 0] == p1[:, 0]) & (p0[:, 1] == p1[:, 1])
        same_cross = (p0[:, 0] == p1[:, 1]) & (p0[:, 1] == p1[:, 0])
        both0_same = p0[:, 0] == p0[:, 1]
        all4 = (cmp(m0[:, 0], m1[:, 0]) & cmp(m0[:, 1], m1[:, 1])
                & cmp(m0[:, 0], m1[:, 1]) & cmp(m0[:, 1], m1[:, 0]))
        direct2 = cmp(m0[:, 0], m1[:, 0]) & cmp(m0[:, 1], m1[:, 1])
        cross2 = cmp(m0[:, 0], m1[:, 1]) & cmp(m0[:, 1], m1[:, 0])
        OTH, DIF = T.ADDB_BS_OTHERS, T.ADDB_BS_DIFF_REFS
        bs_mv = np.where(both0_same,
                         np.where(all4, OTH, DIF),
                         np.where(same_direct,
                                  np.where(direct2, OTH, DIF),
                                  np.where(cross2, OTH, DIF)))
        bs_inter = np.where(same_direct | same_cross, bs_mv, DIF)
        if job.map_ibc is not None:
            ibc_any = job.map_ibc.astype(bool)[cur] \
                | job.map_ibc.astype(bool)[nb]
        else:
            ibc_any = False
        # IBC blocks take BS_INTRA (ref: src_main/xevdm_df.c:411-414)
        bs = np.where(
            if_any & cross_lcu, T.ADDB_BS_INTRA_STRONG,
            np.where(if_any, T.ADDB_BS_INTRA,
                     np.where(ibc_any, T.ADDB_BS_INTRA,
                              np.where(cbf_any | ats_any, T.ADDB_BS_CODED,
                                       bs_inter))))
        return bs.astype(np.int32)

    qp_off = 6 * (bd_c - 8)
    qp_tab_u = chroma_qp_tbl[0]
    qp_tab_v = chroma_qp_tbl[1]
    sh_l = max(0, bd_l - 9)
    sh_c = max(0, bd_c - 9)
    bds = bd_l - 8                          # bitdepth_scale (luma-based)

    luma = np.zeros((2, h_scu, w_scu, 4), np.int32)
    chroma = np.zeros((2, h_scu, w_scu, 7), np.int32)
    edge_hor_c = fs.edge_hor_c if fs.edge_hor_c is not None else fs.edge_hor
    edge_ver_c = fs.edge_ver_c if fs.edge_ver_c is not None else fs.edge_ver

    for d, (edge_l, edge_c) in enumerate(
            ((fs.edge_ver, edge_ver_c), (fs.edge_hor, edge_hor_c))):
        both = (edge_l.astype(bool) | edge_c.astype(bool))
        ys, xs = np.nonzero(both)
        if d == 0:                          # vertical edge: 8-px x grid
            sel = (xs % 2 == 0) & (xs > 0)
            ys, xs = ys[sel], xs[sel]
            nb = (ys, xs - 1)
            cross = ((xs * 4) >> log2_ctu) != (((xs - 1) * 4) >> log2_ctu)
        else:                               # horizontal edge: 8-px y grid
            sel = (ys % 2 == 0) & (ys > 0)
            ys, xs = ys[sel], xs[sel]
            nb = (ys - 1, xs)
            cross = ((ys * 4) >> log2_ctu) != (((ys - 1) * 4) >> log2_ctu)
        if len(ys) == 0:
            continue
        cur = (ys, xs)
        bs = get_bs(cur, nb, cross)
        qp = (fs.map_qp[cur] + fs.map_qp[nb] + 1) >> 1
        is_l = edge_l.astype(bool)[cur]
        is_c = edge_c.astype(bool)[cur]

        idxA = np.clip(qp + alpha_off, 0, 51)
        idxB = np.clip(qp + beta_off, 0, 51)
        luma[d, ys[is_l], xs[is_l], 0] = bs[is_l]
        luma[d, ys[is_l], xs[is_l], 1] = (T.ADDB_ALPHA[idxA] << bds)[is_l]
        luma[d, ys[is_l], xs[is_l], 2] = (T.ADDB_BETA[idxB] << bds)[is_l]
        luma[d, ys[is_l], xs[is_l], 3] = \
            (T.ADDB_CLIP[idxA, bs] << sh_l)[is_l]

        if sps.chroma_format_idc:
            qp_u = np.clip(qp + sh.qp_u_offset, -qp_off, 57)
            qp_v = np.clip(qp + sh.qp_v_offset, -qp_off, 57)
            cu_ = qp_tab_u[qp_u + qp_off]
            cv_ = qp_tab_v[qp_v + qp_off]
            iAu = np.clip(cu_ + alpha_off, 0, 51)
            iBu = np.clip(cu_ + beta_off, 0, 51)
            iAv = np.clip(cv_ + alpha_off, 0, 51)
            iBv = np.clip(cv_ + beta_off, 0, 51)
            c0u = (T.ADDB_CLIP[iAu, bs] + 1) << sh_c
            c0v = (T.ADDB_CLIP[iAv, bs] + 1) << sh_c
            chroma[d, ys[is_c], xs[is_c], 0] = bs[is_c]
            chroma[d, ys[is_c], xs[is_c], 1] = (T.ADDB_ALPHA[iAu] << bds)[is_c]
            chroma[d, ys[is_c], xs[is_c], 2] = (T.ADDB_BETA[iBu] << bds)[is_c]
            chroma[d, ys[is_c], xs[is_c], 3] = c0u[is_c]
            chroma[d, ys[is_c], xs[is_c], 4] = (T.ADDB_ALPHA[iAv] << bds)[is_c]
            chroma[d, ys[is_c], xs[is_c], 5] = (T.ADDB_BETA[iBv] << bds)[is_c]
            chroma[d, ys[is_c], xs[is_c], 6] = c0v[is_c]

    job.addb_luma = luma
    job.addb_chroma = chroma
