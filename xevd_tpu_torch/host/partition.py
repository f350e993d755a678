"""CU partition geometry for the Main profile: BTT splits + SUCO ordering.

The Main profile replaces the Baseline's quadtree with a binary/ternary
tree (BTT) whose allowance rules derive from per-SPS size bounds, plus
SUCO (split-unit coding order), which reverses the left-to-right coding
order of vertically-split partitions.  This module holds the pure
geometry/allowance logic, shared by the entropy decoder (frame.py) and
the test-stream generator (tools/evc_enc.py).

Behavioral reference: src_main/xevdm_util.c:1575-1700 (check_split_mode),
:1702-1728 (suco cond), :3482-3530 (suco order),
src_base/xevd_util.c:1276-1480 (part geometry), xevdm_util.c:4385-4404
(split table init).
"""
from __future__ import annotations

NO_SPLIT = 0
SPLIT_BI_VER = 1
SPLIT_BI_HOR = 2
SPLIT_TRI_VER = 3
SPLIT_TRI_HOR = 4
SPLIT_QUAD = 5

# mode constraints (local dual tree, ref: src_main/xevdm_def.h:472-497)
MODE_CONS_ALL = 0
MODE_CONS_ONLY_INTRA = 1
MODE_CONS_ONLY_INTER = 2

# tree types
TREE_LC = 0
TREE_L = 1
TREE_C = 2

# split-flag context by (log2w-2, log2h-2)
# (ref: src_base/xevd_tbl.c:36-44; NA/NB/NC rows are unreachable shapes)
SPLIT_FLAG_CTX = [
    [255, 4, 4, 14, 15, 15],
    [4, 4, 3, 3, 2, 2],
    [4, 3, 3, 2, 2, 1],
    [14, 3, 2, 2, 1, 1],
    [15, 2, 2, 1, 1, 0],
    [15, 2, 1, 1, 0, 0],
]

# block-ratio rows of the split size table
BLOCK_11, BLOCK_12, BLOCK_14, BLOCK_TT = 0, 1, 2, 3


def split_tbl_init(sps, log2_ctu: int):
    """Per-sequence min/max long-side bounds for each allowed child aspect
    ratio (ref: src_main/xevdm_util.c:4385-4404).  Returns
    tbl[ratio] = (max, min)."""
    min_cb = sps.log2_min_cb_size_minus2 + 2
    tbl = [None] * 4
    tbl[BLOCK_11] = (log2_ctu, min_cb)
    tbl[BLOCK_12] = (log2_ctu, min_cb + 1)
    tbl[BLOCK_14] = (min(log2_ctu - sps.log2_diff_ctu_max_14_cb_size, 6),
                     min_cb + 2)
    tbl[BLOCK_TT] = (min(log2_ctu - sps.log2_diff_ctu_max_tt_cb_size, 6),
                     min_cb + sps.log2_diff_min_cb_min_tt_cb_size_minus2 + 2)
    return tbl


def _allow_ratio(tbl, long_side, ratio):
    if ratio > BLOCK_14:
        return 0
    mx, mn = tbl[ratio]
    return 1 if mn <= long_side <= mx else 0


def _allow_tri(tbl, long_side):
    mx, mn = tbl[BLOCK_TT]
    return 1 if mn <= long_side <= mx else 0


def check_split_mode(log2_cuw, log2_cuh, boundary, boundary_b, boundary_r,
                     log2_ctu, x, y, im_w, im_h, split_tbl, sps_btt,
                     mode_cons=MODE_CONS_ALL):
    """Allowed split set for one node.  Returns dict split->0/1
    (ref: src_main/xevdm_util.c:1575-1687)."""
    allow = {k: 0 for k in (NO_SPLIT, SPLIT_BI_VER, SPLIT_BI_HOR,
                            SPLIT_TRI_VER, SPLIT_TRI_HOR, SPLIT_QUAD)}
    if not sps_btt:
        allow[SPLIT_QUAD] = 1
        return allow

    cu_max = 1 << (log2_ctu - 1)
    from_boundary_b = (y >= im_h - im_h % cu_max) and \
        not (x >= im_w - im_w % cu_max)

    tbl = split_tbl
    if log2_cuw == log2_cuh:
        allow[SPLIT_BI_HOR] = _allow_ratio(tbl, log2_cuw, 1)
        allow[SPLIT_BI_VER] = _allow_ratio(tbl, log2_cuw, 1)
        allow[SPLIT_TRI_VER] = _allow_tri(tbl, log2_cuw) and \
            _allow_ratio(tbl, log2_cuw, 2)
        allow[SPLIT_TRI_HOR] = _allow_tri(tbl, log2_cuh) and \
            _allow_ratio(tbl, log2_cuh, 2)
    elif log2_cuw > log2_cuh:
        allow[SPLIT_BI_HOR] = _allow_ratio(tbl, log2_cuw,
                                           log2_cuw - log2_cuh + 1)
        ls = max(log2_cuw - 1, log2_cuh)
        ratio = abs((log2_cuw - 1) - log2_cuh)
        allow[SPLIT_BI_VER] = _allow_ratio(tbl, ls, ratio)
        if from_boundary_b and ratio in (3, 4):
            allow[SPLIT_BI_VER] = 1
        allow[SPLIT_TRI_VER] = _allow_tri(tbl, log2_cuw)  # w > h here
        allow[SPLIT_TRI_HOR] = 0
    else:
        ls = max(log2_cuw, log2_cuh - 1)
        ratio = abs(log2_cuw - (log2_cuh - 1))
        allow[SPLIT_BI_HOR] = _allow_ratio(tbl, ls, ratio)
        allow[SPLIT_BI_VER] = _allow_ratio(tbl, log2_cuh,
                                           log2_cuh - log2_cuw + 1)
        allow[SPLIT_TRI_VER] = 0
        allow[SPLIT_TRI_HOR] = _allow_tri(tbl, log2_cuh)  # h > w here

    if boundary:
        allow[NO_SPLIT] = 0
        allow[SPLIT_TRI_VER] = 0
        allow[SPLIT_TRI_HOR] = 0
        allow[SPLIT_QUAD] = 0
        if boundary_r:
            allow[SPLIT_BI_HOR] = 0 if allow[SPLIT_BI_VER] else 1
        else:
            allow[SPLIT_BI_VER] = 0 if allow[SPLIT_BI_HOR] else 1

    if mode_cons == MODE_CONS_ONLY_INTER:
        cuw, cuh = 1 << log2_cuw, 1 << log2_cuh
        for m in (SPLIT_BI_VER, SPLIT_BI_HOR, SPLIT_TRI_VER, SPLIT_TRI_HOR):
            if allow[m] and mode_cons_by_split(m, cuw, cuh) != MODE_CONS_ALL:
                allow[m] = 0
    return allow


def mode_cons_by_split(split_mode, cuw, cuh):
    """(ref: src_main/xevdm_util.c:3912-3934)"""
    sw, sh = cuw, cuh
    if split_mode == SPLIT_BI_HOR:
        sh >>= 1
    elif split_mode == SPLIT_BI_VER:
        sw >>= 1
    elif split_mode == SPLIT_TRI_HOR:
        sh >>= 2
    elif split_mode == SPLIT_TRI_VER:
        sw >>= 2
    return MODE_CONS_ONLY_INTRA if (sw == 4 and sh == 4) else MODE_CONS_ALL


def chroma_split_allowed(cuw, cuh, split_mode):
    """4:2:0 local-dual-tree trigger (ref: src_main/xevdm_util.c:3820-3840)."""
    if split_mode == SPLIT_BI_VER:
        cuw >>= 1
    elif split_mode == SPLIT_BI_HOR:
        cuh >>= 1
    elif split_mode == SPLIT_TRI_VER:
        cuw >>= 2
    elif split_mode == SPLIT_TRI_HOR:
        cuh >>= 2
    return 1 if cuw * cuh >= 16 * 4 else 0


def check_suco_cond(cuw, cuh, split_mode, boundary, log2_ctu,
                    suco_max_depth, suco_depth, log2_min_cb):
    """(ref: src_main/xevdm_util.c:1702-1728)"""
    suco_log2_max = min(log2_ctu - suco_max_depth, 6)
    suco_log2_min = max(suco_log2_max - suco_depth, max(4, log2_min_cb))
    if min(cuw, cuh) < (1 << suco_log2_min) or \
            max(cuw, cuh) > (1 << suco_log2_max):
        return 0
    if boundary:
        return 0
    if split_mode in (NO_SPLIT, SPLIT_BI_HOR, SPLIT_TRI_HOR):
        return 0
    if split_mode != SPLIT_QUAD and cuw <= cuh:
        return 0
    return 1


def is_vertical(split_mode):
    return split_mode in (SPLIT_BI_VER, SPLIT_TRI_VER, SPLIT_QUAD)


def part_count(split_mode):
    if split_mode in (SPLIT_BI_VER, SPLIT_BI_HOR):
        return 2
    if split_mode in (SPLIT_TRI_VER, SPLIT_TRI_HOR):
        return 3
    if split_mode == SPLIT_QUAD:
        return 4
    return 1


def suco_order(suco_flag, split_mode):
    """Partition visit order (ref: src_main/xevdm_util.c:3482-3530)."""
    n = part_count(split_mode)
    if not suco_flag:
        return list(range(n))
    if split_mode == SPLIT_QUAD:
        return [1, 0, 3, 2]
    return list(range(n - 1, -1, -1))


def part_structure(split_mode, x0, y0, log2_cuw, log2_cuh):
    """Partition geometry in raster (non-SUCO) part order.  Returns list of
    (x, y, log2w, log2h) (ref: src_base/xevd_util.c:1357-1480)."""
    cuw, cuh = 1 << log2_cuw, 1 << log2_cuh
    if split_mode == NO_SPLIT:
        return [(x0, y0, log2_cuw, log2_cuh)]
    if split_mode == SPLIT_QUAD:
        hw, hh = cuw >> 1, cuh >> 1
        return [(x0, y0, log2_cuw - 1, log2_cuh - 1),
                (x0 + hw, y0, log2_cuw - 1, log2_cuh - 1),
                (x0, y0 + hh, log2_cuw - 1, log2_cuh - 1),
                (x0 + hw, y0 + hh, log2_cuw - 1, log2_cuh - 1)]
    parts = []
    if is_vertical(split_mode):
        x = x0
        for i in range(part_count(split_mode)):
            lw = _part_size_idx(split_mode, i, log2_cuw)
            parts.append((x, y0, lw, log2_cuh))
            x += 1 << lw
    else:
        y = y0
        for i in range(part_count(split_mode)):
            lh = _part_size_idx(split_mode, i, log2_cuh)
            parts.append((x0, y, log2_cuw, lh))
            y += 1 << lh
    return parts


def _part_size_idx(split_mode, part_num, length_idx):
    if split_mode in (SPLIT_BI_VER, SPLIT_BI_HOR):
        return length_idx - 1
    # ternary: middle part is half, outer parts are quarter
    return length_idx - 1 if part_num == 1 else length_idx - 2
