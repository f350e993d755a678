/* Wavefront dependency leveling for the Main intra scan.
 *
 * C port of xevd_tpu/ops/wavefront.py:level_scan_cus (see that module
 * for the semantics; ref: src_base/xevd.c:1470-1526 wavefront threads,
 * src_main/xevdm_ipred.c:39-148 neighbor availability,
 * src_main/xevdm_recon.c:196-370 HTDF window).
 *
 *   level(cu) = 1 + max(level(writer(cell)) for every SCU cell read)
 *
 * Luma and chroma have separate writer maps (local dual trees split a
 * cell's luma and chroma between different CUs).
 */
#include <stdint.h>
#include <string.h>

#define WF_EXPORT __attribute__((visibility("default")))

typedef struct {
    const int32_t *lev;
    int32_t L;
    int h_scu, w_scu;
} WfDep;

static inline void wf_dep(WfDep *ctx, const int64_t *mp, int cy, int cx) {
    if (cy >= 0 && cy < ctx->h_scu && cx >= 0 && cx < ctx->w_scu) {
        int64_t w = mp[(int64_t)cy * ctx->w_scu + cx];
        if (w >= 0) {
            int32_t d = ctx->lev[w] + 1;
            if (d > ctx->L) ctx->L = d;
        }
    }
}

WF_EXPORT void evc_wavefront_levels(
    int n, const int32_t *idx,
    const int32_t *cu_x, const int32_t *cu_y,
    const int32_t *cu_log2w, const int32_t *cu_log2h,
    const int32_t *cu_tree, const int32_t *cu_pred_mode,
    const int64_t *up_m, const int64_t *le_m, const int64_t *ri_m,
    const int64_t *ue_m, const uint8_t *corner,
    const int32_t *htdf_idx, int has_htdf,
    int w_scu, int h_scu, int chroma,
    int32_t *lev_out, int64_t *wl, int64_t *wc)
{
    int64_t cells = (int64_t)w_scu * h_scu;
    for (int64_t i = 0; i < cells; i++) { wl[i] = -1; wc[i] = -1; }

    for (int k = 0; k < n; k++) {
        int i = idx[k];
        int xs = cu_x[i] >> 2, ys = cu_y[i] >> 2;
        int scuw = 1 << (cu_log2w[i] - 2);
        int scuh = 1 << (cu_log2h[i] - 2);
        int tree = cu_tree[i];
        WfDep ctx = {lev_out, 0, h_scu, w_scu};

        if (cu_pred_mode[i] == 0) {                 /* intra */
            const int64_t *maps[2];
            int nm = 0;
            if (tree != 2) maps[nm++] = wl;
            if (tree != 1 && chroma) maps[nm++] = wc;
            for (int m = 0; m < nm; m++) {
                const int64_t *mp = maps[m];
                uint64_t b;
                for (b = (uint64_t)up_m[i]; b;) {
                    int u = __builtin_ctzll(b); b &= b - 1;
                    wf_dep(&ctx, mp, ys - 1, xs + u);
                }
                for (b = (uint64_t)le_m[i]; b;) {
                    int u = __builtin_ctzll(b); b &= b - 1;
                    wf_dep(&ctx, mp, ys + u, xs - 1);
                }
                for (b = (uint64_t)ri_m[i]; b;) {
                    int u = __builtin_ctzll(b); b &= b - 1;
                    wf_dep(&ctx, mp, ys + u, xs + scuw);
                }
                for (b = (uint64_t)ue_m[i]; b;) {
                    int u = __builtin_ctzll(b); b &= b - 1;
                    wf_dep(&ctx, mp, ys - 1, xs - 1 - u);
                }
                if (corner[i]) wf_dep(&ctx, mp, ys - 1, xs - 1);
            }
        }
        if (has_htdf && htdf_idx[i] >= 0) {
            /* conservative one-cell ring (luma) */
            for (int cx = xs - 1; cx <= xs + scuw; cx++) {
                wf_dep(&ctx, wl, ys - 1, cx);
                wf_dep(&ctx, wl, ys + scuh, cx);
            }
            for (int cy = ys; cy < ys + scuh; cy++) {
                wf_dep(&ctx, wl, cy, xs - 1);
                wf_dep(&ctx, wl, cy, xs + scuw);
            }
        }
        lev_out[k] = ctx.L;
        int ye = ys + scuh < h_scu ? ys + scuh : h_scu;
        int xe = xs + scuw < w_scu ? xs + scuw : w_scu;
        for (int cy = ys; cy < ye; cy++)
            for (int cx = xs; cx < xe; cx++) {
                int64_t c = (int64_t)cy * w_scu + cx;
                if (tree != 2) wl[c] = k;
                if (tree != 1 && chroma) wc[c] = k;
            }
    }
}
