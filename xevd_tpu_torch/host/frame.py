"""Host-side entropy pass: parse one Baseline slice into a FrameSyntax batch.

This is the TPU-native equivalent of the reference's sequential entropy pass
(ref: src_base/xevd.c:918-1017 tree recursion, src_base/xevd_eco.c:1048-1176
CU syntax): instead of handing each CU to a scalar recon routine, the parse
emits whole-frame coefficient planes plus flat per-CU arrays — the
host→device tensor payload that the batched JAX/Pallas pixel pipeline
consumes (the analog of XEVD_CU_DATA, ref: src_base/xevd_def.h:1145-1190).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import partition as P
from . import tables as T
from .bitstream import BitReader
from .partition import (MODE_CONS_ALL, MODE_CONS_ONLY_INTER,
                        MODE_CONS_ONLY_INTRA, NO_SPLIT, SPLIT_QUAD, TREE_C,
                        TREE_L, TREE_LC)
from .sbac import Sbac
from .syntax import MalformedBitstream, Pps, SliceHeader, Sps


@dataclass
class FrameSyntax:
    """Flat per-frame syntax tensors (decode order preserved in cu_* arrays)."""
    w: int
    h: int
    w_pad: int
    h_pad: int
    w_scu: int
    h_scu: int
    slice_type: int
    sh: SliceHeader = None
    # full-frame coefficient planes (padded to CTU grid)
    coef_y: np.ndarray = None    # int16 [h_pad, w_pad]
    coef_u: np.ndarray = None    # int16 [h_pad/2, w_pad/2]
    coef_v: np.ndarray = None
    # per-CU arrays, decode order
    cu_x: list = field(default_factory=list)
    cu_y: list = field(default_factory=list)
    cu_log2w: list = field(default_factory=list)
    cu_log2h: list = field(default_factory=list)
    cu_pred_mode: list = field(default_factory=list)
    cu_ipm: list = field(default_factory=list)
    cu_ipm_c: list = field(default_factory=list)
    cu_qp: list = field(default_factory=list)
    cu_qp_u: list = field(default_factory=list)
    cu_qp_v: list = field(default_factory=list)
    cu_cbf: list = field(default_factory=list)       # [3] per cu
    cu_refi: list = field(default_factory=list)      # parsed refi [2]
    cu_mvp_idx: list = field(default_factory=list)   # [2]
    cu_mvd: list = field(default_factory=list)       # [2][2]
    cu_inter_dir: list = field(default_factory=list)
    cu_tree: list = field(default_factory=list)      # TREE_LC/L/C (dual tree)
    cu_mvr_idx: list = field(default_factory=list)   # AMVR resolution index
    cu_bi_idx: list = field(default_factory=list)    # BI_NON/NORMAL/FL0/FL1
    cu_mmvd_flag: list = field(default_factory=list)
    cu_mmvd_idx: list = field(default_factory=list)
    cu_ats: list = field(default_factory=list)       # (ats_cu, mode, inter)
    cu_aff: list = field(default_factory=list)       # affine flag 0/1/2
    cu_aff_mvd: list = field(default_factory=list)   # [2][3][2] CPMV mvds
    # per-SCU maps (filled during entropy; motion pass updates mv/refi)
    map_if: np.ndarray = None     # intra flag u8 [h_scu, w_scu]
    map_qp: np.ndarray = None
    map_cbfl: np.ndarray = None
    map_ipm: np.ndarray = None
    map_skip: np.ndarray = None
    map_ats: np.ndarray = None    # u8: ATS-inter info per SCU (ADDB BS input)
    # CU-edge maps for deblocking (set at CU top/left boundaries)
    edge_hor: np.ndarray = None   # u8: SCU's TOP edge is a CU boundary
    edge_ver: np.ndarray = None   # u8: SCU's LEFT edge is a CU boundary
    # chroma variants: edges of chroma-carrying units only (tree != TREE_L);
    # differ from the luma maps inside local-dual-tree areas
    edge_hor_c: np.ndarray = None
    edge_ver_c: np.ndarray = None
    # per-CTU ALF luma enable map (raster order; all-on unless per-CTU bins)
    alf_ctu_on: np.ndarray = None
    # intra neighbor availability flags per CU (AVAIL_* bits), entropy-time LR
    cu_avail: list = field(default_factory=list)

    def num_cus(self) -> int:
        return len(self.cu_x)

    _SCALAR_FIELDS = ("cu_x", "cu_y", "cu_log2w", "cu_log2h",
                      "cu_pred_mode", "cu_ipm", "cu_ipm_c", "cu_qp",
                      "cu_qp_u", "cu_qp_v", "cu_inter_dir", "cu_tree",
                      "cu_mvr_idx", "cu_bi_idx", "cu_mmvd_flag",
                      "cu_mmvd_idx", "cu_avail", "cu_aff")
    _VEC_FIELDS = {"cu_cbf": (3,), "cu_refi": (2,), "cu_mvp_idx": (2,),
                   "cu_mvd": (2, 2), "cu_ats": (3,), "cu_aff_mvd": (2, 3, 2)}

    def finalize(self):
        """Convert the per-CU lists to int32 numpy tensors (decode order).
        Fields a profile never populated become zero tensors, so consumers
        index unconditionally and the pixel packers vectorize over them."""
        n = len(self.cu_x)
        for name in self._SCALAR_FIELDS:
            v = getattr(self, name)
            if len(v) != n:
                setattr(self, name, np.zeros(n, np.int32))
            else:
                setattr(self, name, np.asarray(v, np.int32).reshape(n))
        for name, shape in self._VEC_FIELDS.items():
            v = getattr(self, name)
            if len(v) != n:
                setattr(self, name, np.zeros((n,) + shape, np.int32))
            else:
                setattr(self, name,
                        np.asarray(v, np.int32).reshape((n,) + shape))
        return self


def get_ctx_some_flags(x_scu, y_scu, scuw, scuh, w_scu, map_skip, map_if,
                       cod):
    """Neighbor-sum context for skip_flag / pred_mode under CM_INIT
    (ref: src_main/xevdm_util.c:1729-1830).  Neighbors: above at the CU's
    top-left, left and right at the CU's bottom row; only entropy-coded
    SCUs count.  Returns (ctx_skip, ctx_pred) clipped to model counts."""
    from .sbac import NUM_CTX_PRED_MODE, NUM_CTX_SKIP_FLAG
    yb = y_scu + scuh - 1
    nbrs = []
    if y_scu > 0 and cod[y_scu - 1, x_scu]:
        nbrs.append((y_scu - 1, x_scu))
    if x_scu > 0 and cod[yb, x_scu - 1]:
        nbrs.append((yb, x_scu - 1))
    if x_scu + scuw < w_scu and cod[yb, x_scu + scuw]:
        nbrs.append((yb, x_scu + scuw))
    if not nbrs:
        return 0, 0
    cs = sum(int(map_skip[p]) for p in nbrs)
    cp = sum(int(map_if[p]) for p in nbrs)
    return (min(cs, NUM_CTX_SKIP_FLAG - 1), min(cp, NUM_CTX_PRED_MODE - 1))


def get_mpm_main(x_scu, y_scu, cuw, cuh, map_if, map_ipm, cod, w_scu):
    """EIPD MPM / extended-MPM / priority-list derivation
    (ref: src_main/xevdm_ipred.c:320-769).  Returns (mpm[2], mpm_ext[8],
    pims[33])."""
    IPD_DC, IPD_PLN, IPD_BI = T.IPD_DC, T.IPD_PLN, T.IPD_BI
    IPD_VER, IPD_HOR, IPD_CNT = T.IPD_VER, T.IPD_HOR, T.IPD_CNT
    IPD_DIA_R, IPD_DIA_L, IPD_DIA_U = T.IPD_DIA_R, T.IPD_DIA_L, T.IPD_DIA_U
    scuw = cuw >> 2
    ipm_l = ipm_u = ipm_r = IPD_DC
    valid_l = valid_u = valid_r = 0
    if x_scu > 0 and map_if[y_scu, x_scu - 1] and cod[y_scu, x_scu - 1]:
        ipm_l = int(map_ipm[y_scu, x_scu - 1])
        valid_l = 1
    if y_scu > 0 and map_if[y_scu - 1, x_scu] and cod[y_scu - 1, x_scu]:
        ipm_u = int(map_ipm[y_scu - 1, x_scu])
        valid_u = 1
    if x_scu + scuw < w_scu and map_if[y_scu, x_scu + scuw] and \
            cod[y_scu, x_scu + scuw]:
        ipm_r = int(map_ipm[y_scu, x_scu + scuw])
        if valid_l and valid_u:
            if ipm_l == ipm_u:
                ipm_u = ipm_r
            else:
                valid_r = 1
        elif not valid_l:
            ipm_l = ipm_r
        elif not valid_u:
            ipm_u = ipm_r
        if valid_r and (ipm_l == ipm_r or ipm_u == ipm_r):
            valid_r = 0

    mpm = [min(ipm_l, ipm_u), max(ipm_l, ipm_u)]
    if mpm[0] == mpm[1]:
        mpm[0] = IPD_DC
        mpm[1] = IPD_BI if mpm[1] == IPD_DC else mpm[1]

    mpm_ext = [0] * 8

    def _fill_from(cands, seeds):
        ext = list(seeds)
        cnt = len(ext)
        for v in cands:
            if cnt > 7:
                break
            hit = False
            for j in range(cnt):
                if v == ext[j] or v == mpm[0] or v == mpm[1]:
                    hit = True
                    break
            if not hit:
                ext.append(v)
                cnt += 1
        return ext[:8] + [0] * max(0, 8 - len(ext))

    if valid_r:
        if mpm[0] < 3 and mpm[1] < 3:
            if ipm_r < 3:
                e0 = 0
                if mpm[0] == IPD_DC:
                    e0 = IPD_PLN if mpm[1] == IPD_BI else IPD_BI
                elif mpm[0] == IPD_PLN:
                    e0 = IPD_DC
                mpm_ext = [e0, IPD_VER, IPD_HOR, IPD_DIA_R, IPD_DIA_L,
                           IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4]
            else:
                lst = [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN, IPD_DIA_L,
                       IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4, IPD_VER - 4,
                       IPD_HOR + 4]
                e0 = 0
                if mpm[0] == IPD_DC:
                    e0 = IPD_PLN if mpm[1] == IPD_BI else IPD_BI
                elif mpm[0] == IPD_PLN:
                    e0 = IPD_DC
                seeds = [e0, ipm_r,
                         ipm_r + 1 if ipm_r in (3, 4) else ipm_r - 2,
                         ipm_r - 1 if ipm_r in (IPD_CNT - 1, IPD_CNT - 2)
                         else ipm_r + 2]
                mpm_ext = _fill_from(lst, seeds)
        elif mpm[0] < 3:
            if ipm_r < 3:
                if mpm[0] == IPD_PLN:
                    e01 = [IPD_BI, IPD_DC]
                else:
                    e01 = [IPD_DC if mpm[0] == IPD_BI else IPD_BI, IPD_PLN]
                if mpm[1] > IPD_CNT - 3:
                    rest = [IPD_CNT - 2 if mpm[1] == IPD_CNT - 1
                            else IPD_CNT - 1, IPD_CNT - 3, IPD_CNT - 4,
                            IPD_CNT - 5, IPD_HOR, IPD_DIA_R]
                elif mpm[1] < 5:
                    rest = [4 if mpm[1] == 3 else 3, 5, 6, 7, IPD_VER,
                            IPD_DIA_R]
                else:
                    rest = [mpm[1] + 2, mpm[1] - 2, mpm[1] + 1, mpm[1] - 1]
                    if 13 <= mpm[1] <= 23:
                        rest += [mpm[1] - 5, mpm[1] + 5]
                    else:
                        rest += [mpm[1] - 5 if mpm[1] > 23 else mpm[1] + 5,
                                 mpm[1] - 10 if mpm[1] > 23 else mpm[1] + 10]
                mpm_ext = e01 + rest
            else:
                lst = [0] * 7 + [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                                 IPD_DIA_L, IPD_DIA_U, IPD_VER + 4,
                                 IPD_HOR - 4]
                lst[0] = ipm_r + 1 if ipm_r in (3, 4) else ipm_r - 2
                lst[1] = (ipm_r - 1 if ipm_r in (IPD_CNT - 1, IPD_CNT - 2)
                          else ipm_r + 2)
                lst[2] = mpm[1] + 1 if mpm[1] in (3, 4) else mpm[1] - 2
                lst[3] = (mpm[1] - 1 if mpm[1] in (IPD_CNT - 1, IPD_CNT - 2)
                          else mpm[1] + 2)
                lst[4] = (ipm_r + mpm[1] + 1) >> 1
                lst[5] = (lst[4] + ipm_r + 1) >> 1
                lst[6] = (lst[4] + mpm[1] + 1) >> 1
                if mpm[0] == IPD_PLN:
                    seeds = [IPD_BI, IPD_DC, ipm_r]
                else:
                    seeds = [IPD_DC if mpm[0] == IPD_BI else IPD_BI,
                             IPD_PLN, ipm_r]
                mpm_ext = _fill_from(lst, seeds)
        else:
            if ipm_r < 3:
                lst = [0] * 7 + [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                                 IPD_DIA_L, IPD_DIA_U, IPD_VER + 4,
                                 IPD_HOR - 4]
                lst[0] = mpm[0] + 1 if mpm[0] in (3, 4) else mpm[0] - 2
                lst[1] = mpm[0] - 1 if mpm[0] == IPD_CNT - 2 else mpm[0] + 2
                lst[2] = mpm[1] + 1 if mpm[1] == 4 else mpm[1] - 2
                lst[3] = (mpm[1] - 1 if mpm[1] in (IPD_CNT - 1, IPD_CNT - 2)
                          else mpm[1] + 2)
                lst[4] = (mpm[0] + mpm[1] + 1) >> 1
                lst[5] = (lst[4] + mpm[0] + 1) >> 1
                lst[6] = (lst[4] + mpm[1] + 1) >> 1
                seeds = [ipm_r, IPD_DC if ipm_r == IPD_BI else IPD_BI]
                mpm_ext = _fill_from(lst, seeds)
            else:
                lst = [0] * 8 + [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                                 IPD_DIA_L, IPD_DIA_U, IPD_VER + 4,
                                 IPD_HOR - 4]
                lst[0] = mpm[0] + 1 if mpm[0] in (3, 4) else mpm[0] - 2
                lst[1] = mpm[0] - 1 if mpm[0] == IPD_CNT - 2 else mpm[0] + 2
                lst[2] = mpm[1] + 1 if mpm[1] == 4 else mpm[1] - 2
                lst[3] = (mpm[1] - 1 if mpm[1] in (IPD_CNT - 1, IPD_CNT - 2)
                          else mpm[1] + 2)
                lst[4] = ipm_r + 1 if ipm_r in (3, 4) else ipm_r - 2
                lst[5] = (ipm_r - 1 if ipm_r in (IPD_CNT - 1, IPD_CNT - 2)
                          else ipm_r + 2)
                lst[6] = ((mpm[0] + ipm_r + 1) >> 1 if ipm_r < mpm[1]
                          else (mpm[0] + mpm[1] + 1) >> 1)
                lst[7] = ((mpm[0] + mpm[1] + 1) >> 1 if ipm_r < mpm[0]
                          else (mpm[1] + ipm_r + 1) >> 1)
                mpm_ext = _fill_from(lst, [IPD_BI, IPD_DC, ipm_r])
    else:
        if mpm[0] < 3 and mpm[1] < 3:
            e0 = 0
            if mpm[0] == IPD_DC:
                e0 = IPD_PLN if mpm[1] == IPD_BI else IPD_BI
            elif mpm[0] == IPD_PLN:
                e0 = IPD_DC
            mpm_ext = [e0, IPD_VER, IPD_HOR, IPD_DIA_R, IPD_DIA_L,
                       IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4]
        elif mpm[0] < 3:
            if mpm[0] == IPD_PLN:
                e01 = [IPD_BI, IPD_DC]
            else:
                e01 = [IPD_DC if mpm[0] == IPD_BI else IPD_BI, IPD_PLN]
            if mpm[1] > IPD_CNT - 3:
                rest = [IPD_CNT - 2 if mpm[1] == IPD_CNT - 1 else IPD_CNT - 1,
                        IPD_CNT - 3, IPD_CNT - 4, IPD_CNT - 5, IPD_HOR,
                        IPD_DIA_R]
            elif mpm[1] < 5:
                rest = [4 if mpm[1] == 3 else 3, 5, 6, 7, IPD_VER, IPD_DIA_R]
            else:
                rest = [mpm[1] + 2, mpm[1] - 2, mpm[1] + 1, mpm[1] - 1]
                if 13 <= mpm[1] <= 23:
                    rest += [mpm[1] - 5, mpm[1] + 5]
                else:
                    rest += [mpm[1] - 5 if mpm[1] > 23 else mpm[1] + 5,
                             mpm[1] - 10 if mpm[1] > 23 else mpm[1] + 10]
            mpm_ext = e01 + rest
        else:
            lst = [0] * 7 + [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN, IPD_DIA_L,
                             IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4]
            lst[0] = mpm[0] + 1 if mpm[0] in (3, 4) else mpm[0] - 2
            lst[1] = mpm[0] - 1 if mpm[0] == IPD_CNT - 2 else mpm[0] + 2
            lst[2] = mpm[1] + 1 if mpm[1] == 4 else mpm[1] - 2
            lst[3] = (mpm[1] - 1 if mpm[1] in (IPD_CNT - 1, IPD_CNT - 2)
                      else mpm[1] + 2)
            lst[4] = (mpm[0] + mpm[1] + 1) >> 1
            lst[5] = (lst[4] + mpm[0] + 1) >> 1
            lst[6] = (lst[4] + mpm[1] + 1) >> 1
            mpm_ext = _fill_from(lst, [IPD_BI, IPD_DC])

    included = [0] * IPD_CNT
    pims = []
    for v in mpm:
        if not included[v]:
            included[v] = 1
            pims.append(v)
    for v in mpm_ext[:8]:
        if not included[v]:
            included[v] = 1
            pims.append(v)
    for v in T.INTRA_MODE_LIST:
        if not included[v]:
            included[v] = 1
            pims.append(v)
    assert len(pims) == IPD_CNT
    return mpm, mpm_ext, pims


# ---------------------------------------------------------------------------
# ADCC neighbor-sum context helpers, shared decoder/encoder
# (ref: src_main/xevdm_util.c:3190-3412).  `coef` is the partially-decoded
# flat raster block; neighbors right/below in raster order are the
# already-visited (higher scan) positions.
# ---------------------------------------------------------------------------
def _adcc_nbr_sum(coef, blkpos, width, height, thresh):
    """Count of the 5 template neighbors with |coef| > thresh."""
    pos_y, pos_x = blkpos // width, blkpos % width
    n = 0
    if pos_x < width - 1:
        n += abs(coef[blkpos + 1]) > thresh
        if pos_x < width - 2:
            n += abs(coef[blkpos + 2]) > thresh
        if pos_y < height - 1:
            n += abs(coef[blkpos + width + 1]) > thresh
    if pos_y < height - 1:
        n += abs(coef[blkpos + width]) > thresh
        if pos_y < height - 2:
            n += abs(coef[blkpos + 2 * width]) > thresh
    return int(n)


def adcc_ctx_sig(coef, blkpos, width, height, ch_type):
    """(ref: src_main/xevdm_util.c:3190-3242)"""
    pos_y, pos_x = blkpos // width, blkpos % width
    diag = pos_x + pos_y
    ctx_idx = min(_adcc_nbr_sum(coef, blkpos, width, height, 0), 4) + 1
    if diag < 2:
        ctx_idx = min(ctx_idx, 2)
    if ch_type == 0:
        ctx_ofs = 0 if diag < 2 else (2 if diag < 5 else 7)
    else:
        ctx_ofs = 0 if diag < 2 else 2
    return ctx_ofs + ctx_idx


def adcc_ctx_gtx(coef, blkpos, width, height, ch_type, thresh):
    """gtA (thresh=1) / gtB (thresh=2) context
    (ref: src_main/xevdm_util.c:3244-3324)."""
    pos_y, pos_x = blkpos // width, blkpos % width
    diag = pos_x + pos_y
    n = min(_adcc_nbr_sum(coef, blkpos, width, height, thresh), 3) + 1
    if ch_type == 0:
        n += 0 if diag < 3 else (4 if diag < 10 else 8)
    return n


def adcc_rice_para(coef, blkpos, width, height, base_level):
    """(ref: src_main/xevdm_util.c:3379-3412)"""
    pos_y, pos_x = blkpos // width, blkpos % width
    s = 0
    if pos_x < width - 1:
        s += abs(coef[blkpos + 1])
        if pos_x < width - 2:
            s += abs(coef[blkpos + 2])
        if pos_y < height - 1:
            s += abs(coef[blkpos + width + 1])
    if pos_y < height - 1:
        s += abs(coef[blkpos + width])
        if pos_y < height - 2:
            s += abs(coef[blkpos + 2 * width])
    s = max(min(int(s) - 5 * base_level, 31), 0)
    return T.ADCC_GO_RICE_PARA[s]


# avail bits (subset used by baseline)
AVAIL_UP = 1 << 0
AVAIL_LE = 1 << 1
AVAIL_RI = 1 << 2
AVAIL_UP_LE = 1 << 3
AVAIL_UP_RI = 1 << 4
AVAIL_LO_LE = 1 << 5
AVAIL_LO_RI = 1 << 6
AVAIL_RI_UP = 1 << 7


class EntropyDecoder:
    """Sequential SBAC + syntax parse of one slice (single tile)."""

    def __init__(self, sps: Sps, pps: Pps, chroma_qp_tbl: np.ndarray,
                 log2_ctu: int = T.CTU_LOG2_B):
        self.sps = sps
        self.pps = pps
        self.chroma_qp_tbl = chroma_qp_tbl
        self.w = sps.pic_width_in_luma_samples
        self.h = sps.pic_height_in_luma_samples
        self.ctu = 1 << log2_ctu
        self.log2_ctu = log2_ctu
        self.w_lcu = (self.w + self.ctu - 1) // self.ctu
        self.h_lcu = (self.h + self.ctu - 1) // self.ctu
        self.w_scu = (self.w + 3) >> 2
        self.h_scu = (self.h + 3) >> 2
        self.is_main = bool(getattr(sps, "is_main", False))
        # min CU size (ref: src_main/xevdm.c:328-340)
        if self.is_main and sps.sps_btt_flag:
            self.min_cuwh = 1 << (sps.log2_min_cb_size_minus2 + 2)
            self.split_tbl = P.split_tbl_init(sps, log2_ctu)
        else:
            self.min_cuwh = 4
            self.split_tbl = None

    def decode_slice(self, bs: BitReader, sh: SliceHeader,
                     num_refp: tuple) -> FrameSyntax:
        sps = self.sps
        w_pad = self.w_lcu * self.ctu
        h_pad = self.h_lcu * self.ctu
        fs = FrameSyntax(
            w=self.w, h=self.h, w_pad=w_pad, h_pad=h_pad,
            w_scu=self.w_scu, h_scu=self.h_scu,
            slice_type=sh.slice_type, sh=sh)
        fs.coef_y = np.zeros((h_pad, w_pad), dtype=np.int16)
        cw_shift = 1 if sps.chroma_format_idc in (1, 2) else 0
        ch_shift = 1 if sps.chroma_format_idc == 1 else 0
        self.cw_shift, self.ch_shift = cw_shift, ch_shift
        if sps.chroma_format_idc:
            fs.coef_u = np.zeros((h_pad >> ch_shift, w_pad >> cw_shift), dtype=np.int16)
            fs.coef_v = np.zeros_like(fs.coef_u)
        fs.map_if = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        fs.map_qp = np.zeros((self.h_scu, self.w_scu), dtype=np.int32)
        fs.map_cbfl = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        fs.map_ipm = np.full((self.h_scu, self.w_scu), -1, dtype=np.int8)
        fs.map_skip = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        fs.map_ats = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        fs.edge_hor = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        fs.edge_ver = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        fs.edge_hor_c = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        fs.edge_ver_c = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        self.cod_eco = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        # coded-CU geometry per SCU (split-flag ctx, ref map_cu_mode LOGW/H)
        self.map_logw = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        self.map_logh = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        self.map_affine = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        self.map_ibc = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)

        self.fs = fs
        self.sh = sh
        self.num_refp = num_refp
        self.qp_prev_eco = sh.qp
        self.cm_init = bool(self.is_main and sps.tool_cm_init)

        sbac = Sbac(bs)
        sbac.reset(bs, sh.slice_type, sh.qp, self.cm_init)
        self.sbac = sbac
        self.bs = bs

        n_ctu = self.w_lcu * self.h_lcu
        # per-CTU ALF luma on/off map: all-on unless signalled per CTU
        # (ref: src_main/xevdm.c:3004 default, :2412-2418 per-CTU bin)
        fs.alf_ctu_on = np.ones(n_ctu, dtype=np.uint8)
        alf_ctb_bins = bool(getattr(sh, "alf_on", 0)
                            and getattr(sh, "alf_is_ctb_alf_on", 0))
        for ctu_idx in range(n_ctu):
            x0 = (ctu_idx % self.w_lcu) << self.log2_ctu
            y0 = (ctu_idx // self.w_lcu) << self.log2_ctu
            if alf_ctb_bins:
                fs.alf_ctu_on[ctu_idx] = sbac.decode_bin(
                    sbac.ctx.alf_ctb_flag, 0)
            if self.is_main:
                self._decode_tree_main(x0, y0, self.log2_ctu, self.log2_ctu,
                                       parent_suco=0, mode_cons=MODE_CONS_ALL)
            else:
                self._decode_tree(x0, y0, self.log2_ctu, self.log2_ctu)
        if sbac.decode_bin_trm() != 1:
            raise MalformedBitstream("missing tile end flag")
        # cabac zero words: remaining bytes must be zero 16-bit words
        while not self.bs.at_end():
            if self.bs.read(16) not in (0, 0xFFFFFFFF):
                raise MalformedBitstream("nonzero cabac_zero_word")
        return fs.finalize()

    # -- CU tree --------------------------------------------------------
    def _decode_tree(self, x0, y0, log2_cuw, log2_cuh):
        """Baseline QT recursion (ref: src_base/xevd.c:918-1017)."""
        cuw = 1 << log2_cuw
        cuh = 1 << log2_cuh
        if cuw > T.MIN_CU_SIZE or cuh > T.MIN_CU_SIZE:
            split = self._read_split(cuw, cuh)
        else:
            split = NO_SPLIT
        if split != NO_SPLIT:
            half = cuw >> 1
            for (xs, ys) in ((x0, y0), (x0 + half, y0), (x0, y0 + half),
                             (x0 + half, y0 + half)):
                if xs < self.w and ys < self.h:
                    self._decode_tree(xs, ys, log2_cuw - 1, log2_cuh - 1)
        else:
            self._decode_cu(x0, y0, log2_cuw, log2_cuh)

    def _read_split(self, cuw, cuh):
        """split_cu_flag (ref: src_base/xevd_eco.c:985-998)."""
        if cuw < 8 and cuh < 8:
            return NO_SPLIT
        bin_ = self.sbac.decode_bin(self.sbac.ctx.split_cu_flag, 0)
        return SPLIT_QUAD if bin_ else NO_SPLIT

    # -- Main tree: BTT + SUCO + local dual tree -------------------------
    def _decode_tree_main(self, x0, y0, log2_cuw, log2_cuh, parent_suco,
                          mode_cons):
        """(ref: src_main/xevdm.c:1640-1850 entropy tree)"""
        sps = self.sps
        cuw = 1 << log2_cuw
        cuh = 1 << log2_cuh
        inside = x0 + cuw <= self.w and y0 + cuh <= self.h

        if cuw > self.min_cuwh or cuh > self.min_cuwh:
            if inside:
                split = self._read_split_mode_main(x0, y0, log2_cuw, log2_cuh,
                                                   mode_cons)
            else:
                boundary_b = (y0 + cuh > self.h) and not (x0 + cuw > self.w)
                boundary_r = (x0 + cuw > self.w) and not (y0 + cuh > self.h)
                if sps.sps_btt_flag:
                    allow = P.check_split_mode(
                        log2_cuw, log2_cuh, 1, boundary_b, boundary_r,
                        self.log2_ctu, x0, y0, self.w, self.h,
                        self.split_tbl, 1, mode_cons)
                    if allow[P.SPLIT_BI_VER]:
                        split = P.SPLIT_BI_VER
                    elif allow[P.SPLIT_BI_HOR]:
                        split = P.SPLIT_BI_HOR
                    else:
                        raise MalformedBitstream("no boundary split allowed")
                else:
                    split = self._read_split(cuw, cuh)
        else:
            split = NO_SPLIT

        bound = not inside
        suco_flag = self._read_suco_flag(cuw, cuh, split, bound, parent_suco)

        if split != NO_SPLIT:
            mode_cons_child = mode_cons
            mode_changed = False
            if sps.sps_btt_flag and sps.tool_admvp:
                mode_changed = (mode_cons == MODE_CONS_ALL
                                and sps.chroma_format_idc != 0
                                and not P.chroma_split_allowed(cuw, cuh, split))
                if mode_changed:
                    if (self.sh.slice_type == T.SLICE_I
                            or P.mode_cons_by_split(split, cuw, cuh)
                            == MODE_CONS_ONLY_INTRA
                            or sps.chroma_format_idc != 1):
                        mode_cons_child = MODE_CONS_ONLY_INTRA
                    else:
                        cf = self._ctx_flags(x0 >> 2, y0 >> 2, cuw, cuh)
                        bin_ = self.sbac.decode_bin(self.sbac.ctx.mode_cons,
                                                    cf["mode_cons"])
                        mode_cons_child = (MODE_CONS_ONLY_INTRA if bin_
                                           else MODE_CONS_ONLY_INTER)
            parts = P.part_structure(split, x0, y0, log2_cuw, log2_cuh)
            order = P.suco_order(
                suco_flag if P.is_vertical(split) else 0, split)
            for pn in order:
                xs, ys, lw, lh = parts[pn]
                if xs < self.w and ys < self.h:
                    self._decode_tree_main(xs, ys, lw, lh, suco_flag,
                                           mode_cons_child)
            if mode_changed and mode_cons_child == MODE_CONS_ONLY_INTRA:
                # local dual tree: chroma of the whole node parsed as one
                # TREE_C unit (ref: src_main/xevdm.c:1833-1838)
                self._decode_cu(x0, y0, log2_cuw, log2_cuh, tree_type=TREE_C,
                                mode_cons=MODE_CONS_ONLY_INTRA)
        else:
            tree_type = (TREE_L if mode_cons == MODE_CONS_ONLY_INTRA
                         else TREE_LC)
            if self.sh.slice_type == T.SLICE_I or (
                    sps.tool_admvp and log2_cuw == 2 and log2_cuh == 2):
                mode_cons = MODE_CONS_ONLY_INTRA
            self._decode_cu(x0, y0, log2_cuw, log2_cuh, tree_type=tree_type,
                            mode_cons=mode_cons)

    def _read_split_mode_main(self, x0, y0, log2_cuw, log2_cuh, mode_cons):
        """BTT split syntax (ref: src_main/xevdm_eco.c:1173-1298)."""
        sbac = self.sbac
        cuw, cuh = 1 << log2_cuw, 1 << log2_cuh
        if cuw < 8 and cuh < 8:
            return NO_SPLIT
        if not self.sps.sps_btt_flag:
            bin_ = sbac.decode_bin(sbac.ctx.split_cu_flag, 0)
            return SPLIT_QUAD if bin_ else NO_SPLIT

        allow = P.check_split_mode(log2_cuw, log2_cuh, 0, 0, 0,
                                   self.log2_ctu, x0, y0, self.w, self.h,
                                   self.split_tbl, 1, mode_cons)
        if not (allow[P.SPLIT_BI_VER] or allow[P.SPLIT_BI_HOR]
                or allow[P.SPLIT_TRI_VER] or allow[P.SPLIT_TRI_HOR]):
            return NO_SPLIT

        if self.cm_init:
            x_scu, y_scu = x0 >> 2, y0 >> 2
            scuw = cuw >> 2
            smaller = 0
            if y_scu > 0:  # up (no cod check in entropy order)
                if (1 << self.map_logw[y_scu - 1, x_scu]) < cuw:
                    smaller += 1
            if x_scu > 0 and self.cod_eco[y_scu, x_scu - 1]:
                if (1 << self.map_logh[y_scu, x_scu - 1]) < cuh:
                    smaller += 1
            if x_scu + scuw < self.w_scu and self.cod_eco[y_scu, x_scu + scuw]:
                if (1 << self.map_logh[y_scu, x_scu + scuw]) < cuh:
                    smaller += 1
            ctx = min(smaller, 2) + 3 * P.SPLIT_FLAG_CTX[log2_cuw - 2][log2_cuh - 2]
        else:
            ctx = 0

        if not sbac.decode_bin(sbac.ctx.btt_split_flag, ctx):
            return NO_SPLIT
        ctx_dir = (log2_cuw - log2_cuh + 2) if self.cm_init else 0
        if (allow[P.SPLIT_BI_VER] or allow[P.SPLIT_TRI_VER]) and \
                (allow[P.SPLIT_BI_HOR] or allow[P.SPLIT_TRI_HOR]):
            split_dir = sbac.decode_bin(sbac.ctx.btt_split_dir, ctx_dir)
        else:
            split_dir = 1 if (allow[P.SPLIT_BI_VER]
                              or allow[P.SPLIT_TRI_VER]) else 0
        if (split_dir and allow[P.SPLIT_BI_VER] and allow[P.SPLIT_TRI_VER]) \
                or (not split_dir and allow[P.SPLIT_BI_HOR]
                    and allow[P.SPLIT_TRI_HOR]):
            split_typ = sbac.decode_bin(sbac.ctx.btt_split_type, 0)
        else:
            split_typ = 1 if ((split_dir and allow[P.SPLIT_TRI_VER]) or
                              (not split_dir and allow[P.SPLIT_TRI_HOR])) \
                else 0
        if split_typ == 0:
            return P.SPLIT_BI_VER if split_dir else P.SPLIT_BI_HOR
        return P.SPLIT_TRI_VER if split_dir else P.SPLIT_TRI_HOR

    def _read_suco_flag(self, cuw, cuh, split_mode, boundary, parent_suco):
        """(ref: src_main/xevdm_eco.c:1300-1334)"""
        sps = self.sps
        if not (self.is_main and sps.sps_suco_flag):
            return 0
        if not P.check_suco_cond(
                cuw, cuh, split_mode, boundary, self.log2_ctu,
                sps.log2_diff_ctu_size_max_suco_cb_size,
                sps.log2_diff_max_suco_min_suco_cb_size,
                (sps.log2_min_cb_size_minus2 + 2) if sps.sps_btt_flag else 2):
            return parent_suco
        if self.cm_init:
            ctx = T.TBL_LOG2[max(cuw, cuh)] - 2
            ctx = ctx * 2 if cuw == cuh else ctx * 2 + 1
        else:
            ctx = 0
        return self.sbac.decode_bin(self.sbac.ctx.suco_flag, ctx)

    def _ctx_flags(self, x_scu, y_scu, cuw, cuh):
        """Neighbor-count contexts for skip/pred/mode_cons/affine/ibc
        (ref: src_main/xevdm_util.c:1729-1830)."""
        from .sbac import (NUM_CTX_AFFINE_FLAG, NUM_CTX_IBC_FLAG,
                           NUM_CTX_MODE_CONS, NUM_CTX_PRED_MODE,
                           NUM_CTX_SKIP_FLAG)
        out = {"skip": 0, "pred": 0, "mode_cons": 0, "affine": 0, "ibc": 0}
        sps = self.sps
        if self.sh.slice_type == T.SLICE_I and (
                not sps.ibc_flag or cuw > (1 << sps.ibc_log_max_size)
                or cuh > (1 << sps.ibc_log_max_size)):
            return out
        scuw, scuh = cuw >> 2, cuh >> 2
        fs = self.fs
        yb = y_scu + scuh - 1
        nbrs = []
        if y_scu > 0 and self.cod_eco[y_scu - 1, x_scu]:
            nbrs.append((y_scu - 1, x_scu))
        if x_scu > 0 and self.cod_eco[yb, x_scu - 1]:
            nbrs.append((yb, x_scu - 1))
        if x_scu + scuw < self.w_scu and self.cod_eco[yb, x_scu + scuw]:
            nbrs.append((yb, x_scu + scuw))
        if not nbrs:
            return out
        if not self.cm_init:
            return out
        cs = cp = ca = ci = 0
        for p in nbrs:
            cs += int(fs.map_skip[p])
            cp += int(fs.map_if[p])
            if self.sh.slice_type != T.SLICE_I:
                ca += int(self.map_affine[p])
            if sps.ibc_flag:
                ci += int(self.map_ibc[p])
        out["skip"] = min(cs, NUM_CTX_SKIP_FLAG - 1)
        out["pred"] = min(cp, NUM_CTX_PRED_MODE - 1)
        # mode_cons neighbor info is never filled in the reference, so its
        # context is always 0 (ref: src_main/xevdm_util.c:1764-1782)
        out["mode_cons"] = 0
        out["affine"] = min(ca, NUM_CTX_AFFINE_FLAG - 1)
        out["ibc"] = min(ci, NUM_CTX_IBC_FLAG - 1)
        return out

    # -- CU syntax ------------------------------------------------------
    def _decode_cu(self, x, y, log2_cuw, log2_cuh, tree_type=TREE_LC,
                   mode_cons=MODE_CONS_ALL):
        """One CU (ref: src_base/xevd_eco.c:1048-1176 Baseline,
        src_main/xevdm_eco.c:1467-1819 Main)."""
        sbac = self.sbac
        ctx = sbac.ctx
        sh = self.sh
        sps = self.sps
        fs = self.fs
        cuw = 1 << log2_cuw
        cuh = 1 << log2_cuh
        x_scu, y_scu = x >> 2, y >> 2
        from . import trace
        if trace.enabled():
            # (trace analog of ref: src_base/xevd.c:775-786)
            trace.line(f"poc: {getattr(self.sh, 'poc_lsb', '?')} "
                       f"x pos {x} y pos {y} width {cuw} height {cuh} "
                       f"tree {tree_type}")
        scuw, scuh = cuw >> 2, cuh >> 2

        pred_mode = T.MODE_INTRA
        mvp_idx = [0, 0]
        mvd = [[0, 0], [0, 0]]
        refi = [T.REFI_INVALID, T.REFI_INVALID]
        inter_dir = 0
        ipm = 0
        ipm_c = None
        cbf = [0, 0, 0]
        only_intra = mode_cons == MODE_CONS_ONLY_INTRA
        check_luma = tree_type != TREE_C
        check_chroma = tree_type != TREE_L

        cf = {"skip": 0, "pred": 0, "mode_cons": 0, "affine": 0, "ibc": 0}
        if self.is_main:
            cf = self._ctx_flags(x_scu, y_scu, cuw, cuh)

        if sh.slice_type != T.SLICE_I and not only_intra:
            if sbac.decode_bin(ctx.skip_flag, cf["skip"]):
                pred_mode = T.MODE_SKIP

        admvp = bool(self.is_main and sps.tool_admvp)
        mvr_idx = 0
        bi_idx = 0   # BI_NON
        mmvd_flag = 0
        mmvd_idx = 0
        aff_flag = 0
        aff_mvd = [[[0, 0], [0, 0], [0, 0]] for _ in range(2)]

        self._last_ats = (0, 0, 0)
        if pred_mode == T.MODE_SKIP:
            if not admvp:
                mvp_idx[0] = sbac.read_truncate_unary_sym(ctx.mvp_idx, 3, 4)
                if sh.slice_type == T.SLICE_B:
                    mvp_idx[1] = sbac.read_truncate_unary_sym(ctx.mvp_idx,
                                                              3, 4)
            else:
                if sps.tool_mmvd:
                    mmvd_flag = sbac.decode_bin(ctx.mmvd_flag, 0)
                if mmvd_flag:
                    mmvd_idx = self._read_mmvd_data(log2_cuw, log2_cuh)
                else:
                    if sps.tool_affine and cuw >= 8 and cuh >= 8:
                        aff_flag = sbac.decode_bin(ctx.affine_flag,
                                                   cf["affine"])
                    if aff_flag:
                        # affine merge idx (ref: xevdm_eco.c:1531-1537)
                        mvp_idx[0] = sbac.read_truncate_unary_sym(
                            ctx.affine_mrg, 5, 5)
                    else:
                        mvp_idx[0] = sbac.read_truncate_unary_sym(
                            ctx.merge_idx, 5, 6)
                        mvp_idx[1] = mvp_idx[0]
            qp = self.qp_prev_eco if self.pps.cu_qp_delta_enabled_flag else sh.qp
        else:
            # pred mode flag + IBC (ref: xevdm_eco_pred_mode,
            # src_main/xevdm_eco.c:1400-1452)
            pred_bin = 0
            if mode_cons == MODE_CONS_ONLY_INTER:
                pred_mode = T.MODE_INTER
            elif sh.slice_type != T.SLICE_I and not only_intra:
                pred_bin = sbac.decode_bin(ctx.pred_mode, cf["pred"])
                pred_mode = T.MODE_INTRA if pred_bin else T.MODE_INTER
            else:
                pred_mode = T.MODE_INTRA
            if self.is_main and sps.ibc_flag \
                    and log2_cuw <= sps.ibc_log_max_size \
                    and log2_cuh <= sps.ibc_log_max_size \
                    and tree_type != TREE_C \
                    and mode_cons != MODE_CONS_ONLY_INTER \
                    and not (mode_cons == MODE_CONS_ALL and pred_bin):
                if sbac.decode_bin(ctx.ibc_flag, cf["ibc"]):
                    pred_mode = T.MODE_IBC

            if pred_mode == T.MODE_INTER:
                if sps.tool_amvr:
                    mvr_idx = sbac.read_truncate_unary_sym(ctx.mvr_idx, 5, 5)
                if sh.slice_type == T.SLICE_B and not admvp:
                    if sbac.decode_bin(ctx.direct_mode_flag, 0):
                        inter_dir = T.PRED_DIR
                elif admvp and mvr_idx == 0:
                    if sbac.decode_bin(ctx.merge_mode_flag, 0):
                        inter_dir = T.PRED_DIR
                if inter_dir == T.PRED_DIR and admvp:
                    # merge (ref: src_main/xevdm_eco.c:1608-1640)
                    if sps.tool_mmvd:
                        mmvd_flag = sbac.decode_bin(ctx.mmvd_flag, 0)
                    if mmvd_flag:
                        mmvd_idx = self._read_mmvd_data(log2_cuw, log2_cuh)
                    else:
                        if sps.tool_affine and cuw >= 8 and cuh >= 8:
                            aff_flag = sbac.decode_bin(ctx.affine_flag,
                                                       cf["affine"])
                        if aff_flag:
                            mvp_idx[0] = sbac.read_truncate_unary_sym(
                                ctx.affine_mrg, 5, 5)
                        else:
                            mvp_idx[0] = sbac.read_truncate_unary_sym(
                                ctx.merge_idx, 5, 6)
                            mvp_idx[1] = mvp_idx[0]
                    pred_mode = T.MODE_DIR
                elif inter_dir != T.PRED_DIR:
                    if sh.slice_type == T.SLICE_B:
                        inter_dir = self._read_inter_pred_idc(
                            cuw, cuh, admvp)
                    if sps.tool_affine and cuw >= 16 and cuh >= 16 and \
                            mvr_idx == 0:
                        aff_flag = sbac.decode_bin(ctx.affine_flag,
                                                   cf["affine"])
                    if aff_flag:
                        # affine AMVP (ref: xevdm_eco.c:1649-1694)
                        aff_flag += sbac.decode_bin(ctx.affine_mode, 0)
                        for lidx in range(2):
                            if ((inter_dir + 1) >> lidx) & 1:
                                refi[lidx] = self._read_refi(
                                    self.num_refp[lidx])
                                mvp_idx[lidx] = \
                                    sbac.read_truncate_unary_sym(
                                        ctx.affine_mvp_idx, 1, 2)
                                bzero = sbac.decode_bin(
                                    ctx.affine_mvd_flag, lidx)
                                for vertex in range(aff_flag + 1):
                                    if bzero:
                                        aff_mvd[lidx][vertex] = [0, 0]
                                    else:
                                        aff_mvd[lidx][vertex] = \
                                            self._read_mvd()
                    elif not admvp:
                        for lidx in range(2):
                            if ((inter_dir + 1) >> lidx) & 1:
                                refi[lidx] = self._read_refi(
                                    self.num_refp[lidx])
                                mvp_idx[lidx] = sbac.read_truncate_unary_sym(
                                    ctx.mvp_idx, 3, 4)
                                mvd[lidx] = self._read_mvd()
                    else:
                        if inter_dir == T.PRED_BI:
                            bi_idx = self._read_bi_idx() + 1
                        for lidx in range(2):
                            if ((inter_dir + 1) >> lidx) & 1:
                                if bi_idx not in (2, 3):  # BI_FL0/BI_FL1
                                    refi[lidx] = self._read_refi(
                                        self.num_refp[lidx])
                                if bi_idx != 2 + lidx:
                                    mvd[lidx] = self._read_mvd()
            elif pred_mode == T.MODE_IBC:
                # block vector coded as one raw mvd
                # (ref: src_main/xevdm_eco.c:1789-1800)
                mvd[0] = self._read_mvd()
            elif not self.is_main:
                ipm = self._read_intra_dir(x_scu, y_scu)
            elif sps.tool_eipd:
                if check_luma:
                    mpm, mpm_ext, pims = get_mpm_main(
                        x_scu, y_scu, cuw, cuh, fs.map_if, fs.map_ipm,
                        self.cod_eco, self.w_scu)
                    ipm = self._read_intra_dir_main(mpm, mpm_ext, pims)
                else:
                    # TREE_C: luma mode inherited from the co-located luma
                    # (ref: src_main/xevdm_eco.c:1743-1757)
                    yc = y_scu + (scuh >> 1)
                    xc = x_scu + (scuw >> 1)
                    if fs.map_if[yc, xc]:
                        ipm = int(fs.map_ipm[yc, xc])
                    else:
                        ipm = T.IPD_DC
                if check_chroma and sps.chroma_format_idc != 0:
                    ipm_c = self._read_intra_dir_c(ipm)
            else:
                if check_luma:
                    ipm = self._read_intra_dir(x_scu, y_scu)
                else:
                    yc = y_scu + (scuh >> 1)
                    xc = x_scu + (scuw >> 1)
                    ipm = int(fs.map_ipm[yc, xc])

            qp, cbf = self._decode_coef(x, y, log2_cuw, log2_cuh, pred_mode,
                                        inter_dir, tree_type)

        qp_u, qp_v = self._chroma_qps(qp)

        from . import trace
        if trace.enabled():
            trace.line(f"cu pred_mode {pred_mode} ipm {ipm} "
                       f"ipm_c {ipm_c} qp {qp} cbf {list(cbf)} "
                       f"refi {list(refi)} mvd {mvd} "
                       f"inter_dir {inter_dir}")
        # record CU
        fs.cu_x.append(x)
        fs.cu_y.append(y)
        fs.cu_log2w.append(log2_cuw)
        fs.cu_log2h.append(log2_cuh)
        fs.cu_pred_mode.append(pred_mode)
        fs.cu_ipm.append(ipm)
        fs.cu_ipm_c.append(ipm if ipm_c is None else ipm_c)
        fs.cu_qp.append(qp)
        fs.cu_qp_u.append(qp_u)
        fs.cu_qp_v.append(qp_v)
        fs.cu_cbf.append(cbf)
        fs.cu_refi.append(refi)
        fs.cu_mvp_idx.append(mvp_idx)
        fs.cu_mvd.append(mvd)
        fs.cu_inter_dir.append(inter_dir)
        fs.cu_tree.append(tree_type)
        fs.cu_mvr_idx.append(mvr_idx)
        fs.cu_bi_idx.append(bi_idx)
        fs.cu_mmvd_flag.append(mmvd_flag)
        fs.cu_mmvd_idx.append(mmvd_idx)
        fs.cu_ats.append(getattr(self, "_last_ats", (0, 0, 0)))
        fs.cu_avail.append(0)
        fs.cu_aff.append(aff_flag)
        fs.cu_aff_mvd.append(aff_mvd)

        # Chroma CU-boundary edge maps: edges of units that carry chroma
        # (tree != TREE_L).  Dual-tree areas deblock luma at TREE_L leaf
        # edges but chroma only at the enclosing TREE_C unit's edges
        # (ref: src_main/xevdm.c deblock_tree TREE_L/TREE_C dispatch), so
        # the full-plane JAX chroma passes need a gating map separate from
        # the luma one.
        if tree_type != TREE_L:
            fs.edge_hor_c[y_scu, x_scu:x_scu + scuw] = 1
            fs.edge_ver_c[y_scu:y_scu + scuh, x_scu] = 1

        if tree_type == TREE_C:
            return  # chroma-only unit: luma maps stay untouched

        # per-SCU map updates (entropy-time, ref: src_base/xevd_util.c:1574)
        ys, xs = slice(y_scu, y_scu + scuh), slice(x_scu, x_scu + scuw)
        is_intra = 1 if pred_mode == T.MODE_INTRA else 0
        fs.map_if[ys, xs] = is_intra
        fs.map_qp[ys, xs] = qp
        ats_inter = getattr(self, "_last_ats", (0, 0, 0))[2]
        fs.map_ats[ys, xs] = ats_inter
        if ats_inter:
            # cbf marked over the coded sub-TU only
            # (ref: src_main/xevdm_util.c xevdm_set_cu_cbf_flags)
            fs.map_cbfl[ys, xs] = 0
            if cbf[0]:
                ltw, lth = T.ats_inter_tu_size(ats_inter, log2_cuw, log2_cuh)
                xo, yo = T.ats_inter_tu_offset(ats_inter, log2_cuw, log2_cuh)
                fs.map_cbfl[y_scu + (yo >> 2):y_scu + ((yo + (1 << lth)) >> 2),
                            x_scu + (xo >> 2):x_scu + ((xo + (1 << ltw)) >> 2)] = 1
        else:
            fs.map_cbfl[ys, xs] = 1 if cbf[0] else 0
        fs.map_skip[ys, xs] = 1 if pred_mode == T.MODE_SKIP else 0
        if is_intra:
            fs.map_ipm[ys, xs] = ipm
        self.cod_eco[ys, xs] = 1
        self.map_logw[ys, xs] = log2_cuw
        self.map_logh[ys, xs] = log2_cuh
        self.map_affine[ys, xs] = aff_flag
        self.map_ibc[ys, xs] = 1 if pred_mode == T.MODE_IBC else 0
        # CU-boundary edge maps for deblocking
        fs.edge_hor[y_scu, xs] = 1
        fs.edge_ver[ys, x_scu] = 1

    def _read_mmvd_data(self, log2_cuw, log2_cuh):
        """(ref: src_main/xevdm_eco.c:767-812)"""
        sbac = self.sbac
        ctx = sbac.ctx
        type_ = (self.sh.mmvd_group_enable_flag
                 and not ((1 << (log2_cuw + log2_cuh)) <= 32))
        t = 0
        if type_:
            t = sbac.decode_bin(ctx.mmvd_group_idx, 0)
            if t:
                t += sbac.decode_bin(ctx.mmvd_group_idx, 1)
        base = sbac.read_truncate_unary_sym(ctx.mmvd_merge_idx, 3, 4)
        idx = base * 32 + t * 128
        idx += sbac.read_truncate_unary_sym(ctx.mmvd_distance_idx, 7, 8) * 4
        idx += sbac.decode_bin(ctx.mmvd_direction_idx, 0) * 2
        idx += sbac.decode_bin(ctx.mmvd_direction_idx, 1)
        return idx

    def _read_bi_idx(self):
        """(ref: src_base/xevd_eco.c:475-497)"""
        sbac = self.sbac
        if sbac.decode_bin(sbac.ctx.bi_idx, 0):
            return 0
        return 1 if sbac.decode_bin(sbac.ctx.bi_idx, 1) else 2

    def _read_inter_pred_idc(self, cuw=64, cuh=64, admvp=False):
        """(ref: src_base/xevd_eco.c:955-983,
        src_main/xevdm_eco.c:1143-1171 — the BI bin is skipped when bi
        prediction is not applicable to this CU size)."""
        from .motion import check_bi_applicability
        sbac = self.sbac
        tmp = 1
        if not admvp or check_bi_applicability(T.SLICE_B, cuw, cuh):
            tmp = sbac.decode_bin(sbac.ctx.inter_dir, 0)
        if not tmp:
            return T.PRED_BI
        tmp = sbac.decode_bin(sbac.ctx.inter_dir, 1)
        return T.PRED_L1 if tmp else T.PRED_L0

    def _read_refi(self, num_refp):
        """(ref: src_base/xevd_eco.c:435-460)"""
        sbac = self.sbac
        ref_num = 0
        if num_refp > 1:
            if sbac.decode_bin(sbac.ctx.refi, 0):
                ref_num += 1
                if num_refp > 2 and sbac.decode_bin(sbac.ctx.refi, 1):
                    ref_num += 1
                    while ref_num < num_refp - 1:
                        if not sbac.decode_bin_ep():
                            break
                        ref_num += 1
        return ref_num

    def _read_mvd(self):
        """(ref: src_base/xevd_eco.c:522-599)"""
        out = [0, 0]
        for d in range(2):
            v = self._read_abs_mvd()
            if v:
                if self.sbac.decode_bin_ep():
                    v = -v
            out[d] = v
        return out

    def _read_abs_mvd(self):
        sbac = self.sbac
        code = sbac.decode_bin(sbac.ctx.mvd, 0)
        if code:
            return 0
        length = 0
        while not (code & 1):
            if length == 0:
                code = sbac.decode_bin(sbac.ctx.mvd, 0)
            else:
                code = sbac.decode_bin_ep()
            length += 1
        val = (1 << length) - 1
        while length:
            length -= 1
            code = sbac.decode_bin_ep()
            val += code << length
        return val

    def _read_intra_dir(self, x_scu, y_scu):
        """MPM-permuted intra mode (ref: src_base/xevd_eco.c:816-840,
        src_base/xevd_ipred.c:678-693)."""
        fs = self.fs
        ipm_l = 0
        ipm_u = 0
        if x_scu > 0 and fs.map_if[y_scu, x_scu - 1] and self.cod_eco[y_scu, x_scu - 1]:
            ipm_l = int(fs.map_ipm[y_scu, x_scu - 1]) + 1
        if y_scu > 0 and fs.map_if[y_scu - 1, x_scu] and self.cod_eco[y_scu - 1, x_scu]:
            ipm_u = int(fs.map_ipm[y_scu - 1, x_scu]) + 1
        mpm = T.MPM_B[ipm_l][ipm_u]
        t0 = self.sbac.read_unary_sym(self.sbac.ctx.intra_dir, 0, 2)
        ipm = 0
        for i in range(T.IPD_CNT_B):
            if t0 == mpm[i]:
                ipm = i
        return ipm

    def _read_intra_dir_main(self, mpm, mpm_ext, pims):
        """EIPD luma mode (ref: src_base/xevd_eco.c:795-879)."""
        sbac = self.sbac
        ctx = sbac.ctx
        if sbac.decode_bin(ctx.intra_luma_pred_mpm_flag, 0):
            return mpm[sbac.decode_bin(ctx.intra_luma_pred_mpm_idx, 0)]
        if sbac.decode_bin_ep():
            return mpm_ext[sbac.decode_bins_ep(3)]
        # truncated binary over IPD_CNT - 10 = 23 symbols
        # (ref: src_base/xevd_eco.c:795-814, threshold 4, val 16, b 7)
        rem = sbac.decode_bins_ep(4)
        if rem >= 16 - 7:
            rem = (rem << 1) + sbac.decode_bin_ep() - (16 - 7)
        return pims[T.INTRA_MPM_NUM + T.INTRA_PIMS_NUM + rem]

    def _read_intra_dir_c(self, ipm_l):
        """EIPD chroma mode (ref: src_base/xevd_eco.c:881-910)."""
        sbac = self.sbac
        conv = {T.IPD_VER: T.IPD_VER_C, T.IPD_HOR: T.IPD_HOR_C,
                T.IPD_DC: T.IPD_DC_C, T.IPD_BI: T.IPD_BI_C}.get(ipm_l)
        ipm = 0
        if sbac.decode_bin(sbac.ctx.intra_chroma_pred_mode, 0) == 0:
            ipm = sbac.read_unary_sym_ep(T.IPD_CHROMA_CNT - 1) + 1
            if conv is not None and ipm >= conv:
                ipm += 1
        return ipm

    # -- coefficients ---------------------------------------------------
    def _read_cbf(self, pred_mode, tree_type, is_sub, sub_pos, b_no_cbf):
        """cbf flags for one (sub-)TU; returns (cbf[3], all_cbf_zero)
        (ref: src_main/xevdm_eco.c:203-301, src_base/xevd_eco.c:601-660)."""
        sbac = self.sbac
        ctx = sbac.ctx
        chroma = self.sps.chroma_format_idc != 0
        cbf = [0, 0, 0]
        if pred_mode != T.MODE_INTRA and tree_type == TREE_LC:
            if not b_no_cbf and sub_pos == 0:
                if sbac.decode_bin(ctx.cbf_all, 0) == 0:
                    return [0, 0, 0], True
            if chroma:
                cbf[1] = sbac.decode_bin(ctx.cbf_cb, 0)
                cbf[2] = sbac.decode_bin(ctx.cbf_cr, 0)
            if cbf[1] + cbf[2] == 0 and not is_sub:
                cbf[0] = 1
            else:
                cbf[0] = sbac.decode_bin(ctx.cbf_luma, 0)
        else:
            if tree_type != TREE_L and chroma:
                cbf[1] = sbac.decode_bin(ctx.cbf_cb, 0)
                cbf[2] = sbac.decode_bin(ctx.cbf_cr, 0)
            if tree_type != TREE_C:
                cbf[0] = sbac.decode_bin(ctx.cbf_luma, 0)
        return cbf, False

    def _decode_coef(self, x, y, log2_cuw, log2_cuh, pred_mode, inter_dir,
                     tree_type=TREE_LC):
        """cbf + dqp + coefficient blocks, with the >MAX_TR sub-TU loop
        (ref: src_base/xevd_eco.c:256-352,601-741,
        src_main/xevdm_eco.c:820-984)."""
        sbac = self.sbac
        sps = self.sps
        fs = self.fs
        # merge/direct CUs skip the cbf_all bin under ADMVP
        # (ref: src_main/xevdm_eco.c:826-835)
        b_no_cbf = bool(self.is_main and sps.tool_admvp
                        and pred_mode == T.MODE_DIR)

        log2_w_sub = min(log2_cuw, T.MAX_TR_LOG2)
        log2_h_sub = min(log2_cuh, T.MAX_TR_LOG2)
        loop_w = 1 << (log2_cuw - log2_w_sub)
        loop_h = 1 << (log2_cuh - log2_h_sub)
        is_sub = loop_w * loop_h > 1
        cbf_any = [0, 0, 0]
        cbf_all = True
        qp = self.qp_prev_eco
        tool_ats = bool(self.is_main and sps.tool_ats)
        ats_avail = T.check_ats_inter_avail(1 << log2_cuw, 1 << log2_cuh,
                                            pred_mode, tool_ats) \
            if pred_mode != T.MODE_INTRA else 0
        self._last_ats = (0, 0, 0)
        for j in range(loop_h):
            for i in range(loop_w):
                if cbf_all:
                    cbf, zero = self._read_cbf(pred_mode, tree_type, is_sub,
                                               j + i, b_no_cbf)
                    if zero:
                        return self.qp_prev_eco, [0, 0, 0]
                else:
                    cbf = [0, 0, 0]

                if self.pps.cu_qp_delta_enabled_flag and \
                        (cbf[0] or cbf[1] or cbf[2]):
                    dqp = self._read_dqp()
                    qp = (self.qp_prev_eco + dqp + 52) % 52
                    self.qp_prev_eco = qp
                else:
                    qp = self.qp_prev_eco

                # ATS syntax (ref: src_main/xevdm_eco.c:889-934)
                ats_cu = ats_mode = ats_inter = 0
                if tool_ats and cbf[0] and log2_cuw <= 5 and \
                        log2_cuh <= 5 and pred_mode == T.MODE_INTRA:
                    ats_cu = self.sbac.decode_bin_ep()
                    if ats_cu:
                        hbit = self.sbac.decode_bin(self.sbac.ctx.ats_mode, 0)
                        vbit = self.sbac.decode_bin(self.sbac.ctx.ats_mode, 0)
                        ats_mode = (hbit << 1) | vbit
                if ats_avail and (cbf[0] or cbf[1] or cbf[2]):
                    ats_inter = self._read_ats_inter_info(
                        log2_cuw, log2_cuh, ats_avail)
                self._last_ats = (ats_cu, ats_mode, ats_inter)

                xs = x + (i << log2_w_sub)
                ys = y + (j << log2_h_sub)
                if cbf[0]:
                    ltw, lth = T.ats_inter_tu_size(ats_inter, log2_w_sub,
                                                   log2_h_sub)
                    xo, yo = T.ats_inter_tu_offset(ats_inter, log2_w_sub,
                                                   log2_h_sub)
                    blk = self._read_coef_block(ltw, lth, 0)
                    fs.coef_y[ys + yo:ys + yo + (1 << lth),
                              xs + xo:xs + xo + (1 << ltw)] = blk
                if cbf[1] or cbf[2]:
                    lw = log2_w_sub - self.cw_shift
                    lh = log2_h_sub - self.ch_shift
                    ltw, lth = T.ats_inter_tu_size(ats_inter, lw, lh)
                    xo, yo = T.ats_inter_tu_offset(ats_inter, lw, lh)
                    xc = (xs >> self.cw_shift) + xo
                    yc = (ys >> self.ch_shift) + yo
                    if cbf[1]:
                        blk = self._read_coef_block(ltw, lth, 1)
                        fs.coef_u[yc:yc + (1 << lth),
                                  xc:xc + (1 << ltw)] = blk
                    if cbf[2]:
                        blk = self._read_coef_block(ltw, lth, 1)
                        fs.coef_v[yc:yc + (1 << lth),
                                  xc:xc + (1 << ltw)] = blk
                cbf_any = [a | b for a, b in zip(cbf_any, cbf)]
        return qp, cbf_any

    def _read_ats_inter_info(self, log2_cuw, log2_cuh, avail):
        """(ref: src_main/xevdm_eco.c eco_ats_inter_info)"""
        sbac = self.sbac
        ctx = sbac.ctx
        mode_vert = avail & 1
        mode_hori = (avail >> 1) & 1
        mode_vert_quad = (avail >> 2) & 1
        mode_hori_quad = (avail >> 3) & 1
        ctx_f = ((0 if log2_cuw + log2_cuh >= 8 else 1)
                 if self.cm_init else 0)
        ctx_h = ((0 if log2_cuw == log2_cuh
                  else (1 if log2_cuw < log2_cuh else 2))
                 if self.cm_init else 0)
        if not sbac.decode_bin(ctx.ats_cu_inter_flag, ctx_f):
            return 0
        if (mode_vert_quad or mode_hori_quad) and (mode_vert or mode_hori):
            quad = sbac.decode_bin(ctx.ats_cu_inter_quad_flag, 0)
        else:
            quad = 0
        if (quad and mode_vert_quad and mode_hori_quad) or \
                (not quad and mode_vert and mode_hori):
            hor = sbac.decode_bin(ctx.ats_cu_inter_hor_flag, ctx_h)
        else:
            hor = 1 if ((quad and mode_hori_quad)
                        or (not quad and mode_hori)) else 0
        pos = sbac.decode_bin(ctx.ats_cu_inter_pos_flag, 0)
        idx = (2 if quad else 0) + (1 if hor else 0) + 1
        return idx + (pos << 4)

    def _read_dqp(self):
        sbac = self.sbac
        dqp = sbac.read_unary_sym(sbac.ctx.delta_qp, 0, 1)
        if dqp > 0 and sbac.decode_bin_ep():
            dqp = -dqp
        return dqp

    def _read_coef_block(self, log2_w, log2_h, ch_type) -> np.ndarray:
        """Coefficient block dispatch (ref: src_main/xevdm_eco.c:697-729)."""
        if self.is_main and self.sps.tool_adcc:
            return self._read_coef_adcc(log2_w, log2_h, ch_type)
        return self._read_coef_rl(log2_w, log2_h, ch_type)

    def _read_coef_rl(self, log2_w, log2_h, ch_type) -> np.ndarray:
        """Run/level zigzag (ref: src_base/xevd_eco.c:354-411; CM_INIT ctx
        selection ref: src_main/xevdm_eco.c:303-352)."""
        sbac = self.sbac
        ctx = sbac.ctx
        scanp = T.SCAN_TBL[(log2_w, log2_h)]
        num_coeff = 1 << (log2_w + log2_h)
        coef = np.zeros(num_coeff, dtype=np.int16)
        sps = self.sps
        cm_init = self.cm_init
        ctx_last = 0 if ch_type == 0 else 1
        pos = 0
        prev_level = 6
        while True:
            if cm_init:
                t0 = (min(prev_level - 1, 5) << 1) + (0 if ch_type == 0 else 12)
            else:
                t0 = 0 if ch_type == 0 else 2
            run = sbac.read_unary_sym(ctx.run, t0, 2)
            pos += run
            level = sbac.read_unary_sym(ctx.level, t0, 2) + 1
            prev_level = level
            sign = sbac.decode_bin_ep()
            coef[scanp[pos]] = -level if sign else level
            if pos >= num_coeff - 1:
                break
            pos += 1
            if sbac.decode_bin(ctx.last, ctx_last):
                break
        return coef.reshape(1 << log2_h, 1 << log2_w)

    def _read_last_pos_xy(self, log2_w, log2_h, ch_type):
        """last_sig_coeff_{x,y} prefix/suffix
        (ref: src_main/xevdm_eco.c:395-463)."""
        sbac = self.sbac
        width, height = 1 << log2_w, 1 << log2_h
        base = 0 if ch_type == 0 else \
            (T.NUM_CTX_LAST_SIG_COEFF_LUMA if self.cm_init else 11)
        cm_x = sbac.ctx.last_sig_coeff_x_prefix
        cm_y = sbac.ctx.last_sig_coeff_y_prefix
        if self.cm_init:
            off_x, off_y, sh_x, sh_y = T.adcc_last_pos_ctx_para(
                ch_type, width, height)
        else:
            off_x = off_y = sh_x = sh_y = 0
        pos_x = 0
        while pos_x < T.ADCC_GROUP_IDX[width - 1]:
            if not sbac.decode_bin(cm_x, base + off_x + (pos_x >> sh_x)):
                break
            pos_x += 1
        pos_y = 0
        while pos_y < T.ADCC_GROUP_IDX[height - 1]:
            if not sbac.decode_bin(cm_y, base + off_y + (pos_y >> sh_y)):
                break
            pos_y += 1
        if pos_x > 3:
            cnt = (pos_x - 2) >> 1
            tmp = sbac.decode_bins_ep(cnt)
            pos_x = T.ADCC_MIN_IN_GROUP[pos_x] + tmp
        if pos_y > 3:
            cnt = (pos_y - 2) >> 1
            tmp = sbac.decode_bins_ep(cnt)
            pos_y = T.ADCC_MIN_IN_GROUP[pos_y] + tmp
        return pos_x, pos_y

    def _read_remain_exgolomb(self, rparam):
        """(ref: src_main/xevdm_eco.c:464-491)"""
        sbac = self.sbac
        prefix = 0
        while sbac.decode_bin_ep():
            prefix += 1
        rng = T.ADCC_GO_RICE_RANGE[rparam]
        if prefix < rng:
            suffix = sbac.decode_bins_ep(rparam) if rparam else 0
            return (prefix << rparam) + suffix
        suffix = sbac.decode_bins_ep(prefix - rng + rparam)
        return (((1 << (prefix - rng)) + rng - 1) << rparam) + suffix

    def _read_coef_adcc(self, log2_w, log2_h, ch_type) -> np.ndarray:
        """ADCC coefficient decode (ref: src_main/xevdm_eco.c:492-693)."""
        sbac = self.sbac
        width, height = 1 << log2_w, 1 << log2_h
        coef = [0] * (width * height)      # partial values feed the contexts
        last_x, last_y = self._read_last_pos_xy(log2_w, log2_h, ch_type)
        scan = T.SCAN_TBL[(log2_w, log2_h)]
        scan_inv = T.INV_SCAN_TBL[(log2_w, log2_h)]
        num_coeff = int(scan_inv[last_x + last_y * width]) + 1

        log2_block = min(log2_w, log2_h)
        if self.cm_init:
            offset0 = 0 if log2_block <= 2 else \
                T.NUM_CTX_SIG_COEFF_LUMA_TU << min(1, log2_block - 3)
            sig_base = offset0 if ch_type == 0 else T.NUM_CTX_SIG_COEFF_LUMA
            gtx_base = 0 if ch_type == 0 else T.NUM_CTX_GTX_LUMA
        else:
            sig_base = 0 if ch_type == 0 else 1
            gtx_base = 0 if ch_type == 0 else 1
        cm_sig = sbac.ctx.sig_coeff_flag
        cm_gtx = sbac.ctx.coeff_abs_level_greaterAB_flag

        cg_size = 1 << T.LOG2_CG_SIZE
        last_scan_set = (num_coeff - 1) >> T.LOG2_CG_SIZE
        scan_pos_last = num_coeff - 1
        ipos = scan_pos_last
        is_last_nz = False
        pos_last = 0
        ctx_gtA = ctx_gtB = 0

        for sub_set in range(last_scan_set, -1, -1):
            sub_pos = sub_set << T.LOG2_CG_SIZE
            pos = []
            abs_coef = []
            while ipos >= sub_pos:
                blkpos = int(scan[ipos])
                if ipos == scan_pos_last:
                    sig = 1
                else:
                    ctx_sig = adcc_ctx_sig(coef, blkpos, width, height,
                                           ch_type) if self.cm_init else 0
                    sig = sbac.decode_bin(cm_sig, sig_base + ctx_sig)
                coef[blkpos] = sig
                if sig:
                    pos.append(blkpos)
                    if not is_last_nz:
                        pos_last = blkpos
                        is_last_nz = True
                ipos -= 1
            num_nz = len(pos)
            if num_nz == 0:
                continue
            abs_coef = [1] * num_nz
            escape = False
            first_c2 = -1
            for idx in range(min(num_nz, T.CAFLAG_NUMBER)):
                if pos[idx] != pos_last and self.cm_init:
                    ctx_gtA = adcc_ctx_gtx(coef, pos[idx], width, height,
                                           ch_type, 1)
                elif pos[idx] != pos_last:
                    ctx_gtA = 0
                gtA = sbac.decode_bin(cm_gtx, gtx_base + ctx_gtA)
                coef[pos[idx]] += gtA
                abs_coef[idx] = gtA + 1
                if gtA:
                    if first_c2 == -1:
                        first_c2 = idx
                    else:
                        escape = True
            if first_c2 != -1:
                if pos[first_c2] != pos_last and self.cm_init:
                    ctx_gtB = adcc_ctx_gtx(coef, pos[first_c2], width,
                                           height, ch_type, 2)
                elif pos[first_c2] != pos_last:
                    ctx_gtB = 0
                gtB = sbac.decode_bin(cm_gtx, gtx_base + ctx_gtB)
                coef[pos[first_c2]] += gtB
                abs_coef[first_c2] = gtB + 2
                if gtB:
                    escape = True
            escape = escape or (num_nz > T.CAFLAG_NUMBER)
            if escape:
                first2 = 1
                for idx in range(num_nz):
                    base_level = (2 + first2) if idx < T.CAFLAG_NUMBER else 1
                    if abs_coef[idx] >= base_level:
                        rparam = adcc_rice_para(coef, pos[idx], width,
                                                height, base_level)
                        rem = self._read_remain_exgolomb(rparam)
                        coef[pos[idx]] = rem + base_level
                        abs_coef[idx] = rem + base_level
                    if abs_coef[idx] >= 2:
                        first2 = 0
            signs = sbac.decode_bins_ep(num_nz)
            for idx in range(num_nz):
                v = abs_coef[idx]
                if (signs >> (num_nz - 1 - idx)) & 1:
                    v = -v
                coef[pos[idx]] = v
        out = np.asarray(coef, dtype=np.int64)
        # coefficients are carried as s16 in the reference
        out = ((out + 0x8000) & 0xFFFF) - 0x8000
        return out.astype(np.int16).reshape(height, width)

    def _chroma_qps(self, qp):
        sps = self.sps
        bdc_m8 = sps.bit_depth_chroma_minus8
        off = 6 * bdc_m8
        qp_i_cb = np.clip(qp + self.sh.qp_u_offset, -off, 57)
        qp_i_cr = np.clip(qp + self.sh.qp_v_offset, -off, 57)
        qp_u = int(self.chroma_qp_tbl[0][qp_i_cb + off]) + off
        qp_v = int(self.chroma_qp_tbl[1][qp_i_cr + off]) + off
        return qp_u, qp_v
