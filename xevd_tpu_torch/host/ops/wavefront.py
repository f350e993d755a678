"""Host-side wavefront scheduling for the Main intra scan.

The reference reconstructs intra CUs strictly sequentially (per-CU
dependency on already-reconstructed neighbor pixels, ref:
src_base/xevd.c:1470-1526 wavefront threads).  The device scan used to
mirror that order one CU per `lax.scan` step — ~0.5 ms of fixed step cost
per CU, the config-3/4 throughput ceiling.  This module computes an
equivalent schedule with provably-independent batches:

  level(cu) = 1 + max(level(writer(cell)) for every SCU cell the CU reads)

where reads come from the CU's actual neighbor-availability masks (up /
left / right / up-extension / corner, ref: src_main/xevdm_ipred.c:39-148)
plus a conservative one-cell ring for HTDF (ref: xevdm_recon.c:196-370).
CUs sharing a level touch disjoint pixels, so the device processes each
level as one batched (vmapped) step — pixel-exact with the serial order.

Luma and chroma have separate writer maps: local dual trees split a cell's
luma (TREE_L leaves) and chroma (the enclosing TREE_C unit) between
different CUs (ref: src_main/xevdm.c:1833-1838).
"""
from __future__ import annotations

import numpy as np


def _bits(mask):
    out = []
    m = int(mask)
    while m:
        b = m & -m
        out.append(b.bit_length() - 1)
        m ^= b
    return out


def level_scan_cus(fs, job, idx, chroma):
    """Dependency levels for the scan CUs `idx` (decode order).
    Returns int32 [len(idx)] levels (0-based)."""
    try:
        from .. import native
        if native.available():
            return native.wavefront_levels(fs, job, idx, chroma)
    except Exception:
        pass
    h_scu, w_scu = fs.h_scu, fs.w_scu
    wl = np.full((h_scu, w_scu), -1, np.int64)   # luma-writer scan index
    wc = np.full((h_scu, w_scu), -1, np.int64)   # chroma-writer scan index
    n = len(idx)
    lev = np.zeros(n, np.int32)
    cu_x, cu_y = fs.cu_x, fs.cu_y
    cu_lw, cu_lh = fs.cu_log2w, fs.cu_log2h
    cu_tree = fs.cu_tree
    intra = fs.cu_pred_mode == 0
    up_m, le_m = job.cu_nbr_up, job.cu_nbr_left
    ri_m, ue_m = job.cu_nbr_right, job.cu_nbr_upext
    corner = job.cu_nbr_corner
    htdf_idx = job.cu_htdf_idx

    for k in range(n):
        i = idx[k]
        xs, ys = int(cu_x[i]) >> 2, int(cu_y[i]) >> 2
        scuw = 1 << (int(cu_lw[i]) - 2)
        scuh = 1 << (int(cu_lh[i]) - 2)
        tree = int(cu_tree[i])
        L = 0

        def dep(mp, cy, cx):
            nonlocal L
            if 0 <= cy < h_scu and 0 <= cx < w_scu:
                w = mp[cy, cx]
                if w >= 0:
                    d = lev[w] + 1
                    if d > L:
                        L = d

        if intra[i]:
            maps = []
            if tree != 2:
                maps.append(wl)
            if tree != 1 and chroma:
                maps.append(wc)
            for mp in maps:
                for u in _bits(up_m[i]):
                    dep(mp, ys - 1, xs + u)
                for u in _bits(le_m[i]):
                    dep(mp, ys + u, xs - 1)
                for u in _bits(ri_m[i]):
                    dep(mp, ys + u, xs + scuw)
                for u in _bits(ue_m[i]):
                    dep(mp, ys - 1, xs - 1 - u)
                if corner[i]:
                    dep(mp, ys - 1, xs - 1)
        if htdf_idx is not None and htdf_idx[i] >= 0:
            # conservative one-cell ring (luma)
            for cx in range(xs - 1, xs + scuw + 1):
                dep(wl, ys - 1, cx)
                dep(wl, ys + scuh, cx)
            for cy in range(ys, ys + scuh):
                dep(wl, cy, xs - 1)
                dep(wl, cy, xs + scuw)
        lev[k] = L
        ye, xe = min(ys + scuh, h_scu), min(xs + scuw, w_scu)
        if tree != 2:
            wl[ys:ye, xs:xe] = k
        if tree != 1 and chroma:
            wc[ys:ye, xs:xe] = k
    return lev


def group_wavefront(rows, levels, log2w, log2h, bucket_rows):
    """Group scan rows into fixed-width step slots per size class.

    Levels are split into as many consecutive steps as the widest class
    needs (CUs of one level are independent, so spreading them over
    several steps keeps correctness), giving constant per-class slot
    counts — padding stays bounded and the jit key only varies in the
    step count (pow2-bucketed).  Returns {tile_S: int32 [L, B_c, ncol]}.
    """
    n, ncol = rows.shape
    smax = np.maximum(log2w, log2h)
    cls = np.clip(smax, 3, 6)          # 3..6 -> tiles 8..64
    n_lev = int(levels.max()) + 1 if n else 0
    SLOTS = {3: 32, 4: 8, 5: 4, 6: 2}
    present = [c for c in (3, 4, 5, 6) if (cls == c).any()]

    # per-level per-class counts -> steps per level
    counts = {c: np.bincount(levels[cls == c], minlength=n_lev)
              for c in present}
    steps_per_level = np.ones(n_lev, np.int64)
    for c in present:
        need = -(-counts[c] // SLOTS[c])     # ceil
        steps_per_level = np.maximum(steps_per_level, need)
    step_base = np.concatenate([[0], np.cumsum(steps_per_level)])
    total_steps = int(step_base[-1])
    L = bucket_rows("wfL", max(total_steps, 1))

    out = {}
    for c in present:
        b = SLOTS[c]
        arr = np.zeros((L, b, ncol), np.int32)
        if ncol > 13:
            arr[:, :, 14] = -1          # padding rows: no htdf
        sel = np.nonzero(cls == c)[0]
        fill = np.zeros(total_steps, np.int64)
        for j in sel:
            lv = levels[j]
            k = step_base[lv]
            while fill[k] == b:
                k += 1
            arr[k, fill[k]] = rows[j]
            fill[k] += 1
        out[1 << c] = arr
    return out
