/* Each CU row's depth in its frame's dependency DAG under the Baseline
 * intra scan's wait rule (csrc/intra.cu): the host half of the GOP batch's
 * ticket order (ops/pack.py `icu_order`).  ops/intra.py `intra_depths` is
 * the plain statement (with `intra_deps_ref`), and this pass equals it,
 * errors included; it exists because the batch orders some 80,000 rows a
 * step of 1080p I pictures, which takes the plain version ~20 ms a
 * picture.
 *
 *   depth(r) = 1 + max(depth(writer(c)) for every cell c that r's up mask
 *              (units 0 .. 2 sw - 1), left mask and corner flag name)
 *
 * on the 4x4 cells of an hs x ws grid, a cell without a writer counting
 * 0; an invalid row writes and waits on nothing and has depth 0. */
#include <stdint.h>

#define EXPORT __attribute__((visibility("default")))

/* icu: int32 [n, 8] rows (x, y, log2, ipm, up_mask, left_mask, corner,
 * valid); owner: int32 [hs * ws] scratch; depth: int32 [n], out.
 * Returns 0; -(r + 1) when row r's block leaves the grid, 2 n + r + 1
 * when it overlaps an earlier row's, n + r + 1 when a cell its masks
 * name is written by row r or a later one (a non-causal table). */
EXPORT int xevd_intra_depths(const int32_t *icu, int n, int hs, int ws,
                             int32_t *owner, int32_t *depth) {
    for (int64_t i = 0; i < (int64_t)hs * ws; i++) owner[i] = -1;
    for (int r = 0; r < n; r++) {           /* the writer map */
        const int32_t *c = icu + 8 * (int64_t)r;
        if (c[7] != 1) continue;
        int xs = c[0] >> 2, ys = c[1] >> 2;
        int sw = c[2] > 2 ? 1 << (c[2] - 2) : 1;
        if (xs < 0 || ys < 0 || xs + sw > ws || ys + sw > hs)
            return -(r + 1);
        for (int y = ys; y < ys + sw; y++)
            for (int x = xs; x < xs + sw; x++) {
                if (owner[y * ws + x] >= 0) return 2 * n + r + 1;
                owner[y * ws + x] = r;
            }
    }
    for (int r = 0; r < n; r++) {           /* writers precede readers */
        const int32_t *c = icu + 8 * (int64_t)r;
        depth[r] = 0;
        if (c[7] != 1) continue;
        int xs = c[0] >> 2, ys = c[1] >> 2;
        int nu = c[2] > 2 ? 2 << (c[2] - 2) : 2;
        uint32_t up = (uint32_t)c[4], le = (uint32_t)c[5];
        int d = 0;
        for (int k = 0; k <= 2 * nu && k <= 64; k++) {
            int cy, cx;
            if (k < nu) {
                if (k >= 32 || !((up >> k) & 1u)) continue;
                cy = ys - 1;
                cx = xs + k;
            } else if (k < 2 * nu) {
                int u = k - nu;
                if (u >= 32 || !((le >> u) & 1u)) continue;
                cy = ys + u;
                cx = xs - 1;
            } else {
                if (c[6] != 1) continue;
                cy = ys - 1;
                cx = xs - 1;
            }
            if (cy < 0 || cy >= hs || cx < 0 || cx >= ws) continue;
            int w = owner[cy * ws + cx];
            if (w < 0) continue;
            if (w >= r) return n + r + 1;
            if (depth[w] > d) d = depth[w];
        }
        depth[r] = d + 1;
    }
    return 0;
}
