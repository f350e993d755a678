/* Native host derive pass for xevd_tpu: Main-profile motion reconstruction,
 * intra availability masks and HTDF gating, in decode order.
 *
 * Mirrors derive.derive_frame's per-CU loop + motion.py bit-for-bit:
 * merge candidate lists with TMVP/HMVP/pairwise
 * (ref: src_main/xevdm_util.c:1169-1405), AMVR-aware MVP (:869-1000),
 * MMVD motion (:192-593), temporal collocated scaling (:3729-3820),
 * neighbor availability (:594-744), plus the baseline MVP/direct paths
 * (ref: src_base/xevd.c:477-565) used when tool_admvp is off.
 * Deblock-strength/ADDB parameter maps stay in Python (vectorized numpy).
 * Pure C99, ctypes.
 */
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define SLICE_B 0
#define SLICE_P 1
#define SLICE_I 2
#define MODE_INTRA 0
#define MODE_INTER 1
#define MODE_SKIP 2
#define MODE_DIR 3
#define MODE_IBC 6
#define PRED_DIR 4
#define REFI_INVALID (-1)

#define MAXM_NUM_MVP 6
#define MAX_NUM_MVP_SMALL_CU 4
#define NUM_SAMPLES_BLOCK 32
#define ALLOWED_CHECKED_NUM 23
#define ALLOWED_CHECKED_NUM_SMALL_CU 15
#define ALLOWED_CHECKED_AMVP_NUM 4
#define MVP_SCALING_PRECISION 5
#define LR_01 2
#define LR_11 3
#define PIC_PAD_SIZE_L 144

/* HTDF availability bits (ops/htdf.py:22-28) */
#define HT_LE 1
#define HT_RI 2
#define HT_UP 4
#define HT_UP_LE 8
#define HT_UP_RI 16
#define HT_LO_LE 32
#define HT_LO_RI 64

/* CU record layout — must match evc_main.c */
enum {
    M_X = 0, M_Y, M_LOG2W, M_LOG2H, M_PRED_MODE, M_IPM, M_IPM_C,
    M_QP, M_QP_U, M_QP_V, M_CBF_Y, M_CBF_U, M_CBF_V,
    M_REFI0, M_REFI1, M_MVP0, M_MVP1,
    M_MVD0X, M_MVD0Y, M_MVD1X, M_MVD1Y,
    M_INTER_DIR, M_TREE, M_MVR_IDX, M_BI_IDX, M_MMVD_FLAG, M_MMVD_IDX,
    M_ATS_CU, M_ATS_MODE, M_ATS_INTER,
    M_AFF_FLAG, M_AFF_MVD, MAIN_CU_FIELDS = M_AFF_MVD + 12
};

/* derive params layout (native.py must match) */
enum {
    D_W = 0, D_H, D_SLICE_TYPE, D_POC, D_LOG2_CTU, D_ADMVP, D_HMVP,
    D_HTDF, D_CONSTRAINED, D_NUM_REFP0, D_NUM_REFP1,
    D_TMVP_ASSIGNED, D_COL_LIST, D_COL_REF, D_COL_SRC_LIST,
    D_SH_QP, D_R1_POC, D_R1_LIST_POC0, NUM_DPARAMS
};

#define MAX_REFP 16

typedef struct {
    const int32_t *p;
    int w_scu, h_scu;
    int slice_type, poc;
    /* decode-order SCU state */
    const uint8_t *map_if;
    uint8_t *cod;
    int16_t *map_mv;       /* [h][w][2][2] */
    int8_t *map_refi;      /* [h][w][2]    */
    /* HMVP history: newest-last ring as flat list */
    int hist_n;
    int hist_refi[ALLOWED_CHECKED_NUM][2];
    int hist_mv[ALLOWED_CHECKED_NUM][2][2];
    /* reference data */
    int refp_poc[2][MAX_REFP];
    const int8_t *col_refi;       /* collocated pic maps, or NULL */
    const int16_t *col_mv;
    int col_poc;
    const int32_t *col_list_poc;
    const int16_t *r00_mv;        /* refp[0][0].map_mv (baseline tmvp) */
    const int16_t *r01_mv;        /* refp[0][1].map_mv */
    int r1_poc, r1_list_poc0;
    /* affine per-SCU state (AffineMaps): flag 0/1/2 + owning-CU geometry */
    uint8_t *am_aff, *am_logw, *am_logh;
    uint16_t *am_xoff, *am_yoff;
    uint8_t *map_ibc;
} DM;

static int s16c(long long v) {
    if (v < -32768) return -32768;
    if (v > 32767) return 32767;
    return (int)v;
}

static int s16w(int v) {
    v &= 0xFFFF;
    return v >= 0x8000 ? v - 0x10000 : v;
}

static long long c_div(long long a, long long b) {
    long long q = (a < 0 ? -a : a) / (b < 0 ? -b : b);
    return ((a < 0) != (b < 0)) ? -q : q;
}

static void scaling_mv(long long ratio, const int mv[2], int out[2]) {
    /* (ref: src_main/xevdm_util.c scaling_mv) */
    for (int dd = 0; dd < 2; dd++) {
        long long t = (long long)mv[dd] * ratio;
        long long v;
        if (t == 0) v = 0;
        else if (t > 0)
            v = (t + (1 << (MVP_SCALING_PRECISION - 1)))
                >> MVP_SCALING_PRECISION;
        else
            v = -((-t + (1 << (MVP_SCALING_PRECISION - 1)))
                  >> MVP_SCALING_PRECISION);
        out[dd] = s16c(v);
    }
}

static int dm_avail_lr(DM *d, int x_scu, int y_scu, int scuw) {
    /* (ref: src_base/xevd_util.c:1156-1174) */
    int lr = 0;
    if (x_scu > 0 && d->cod[y_scu * d->w_scu + x_scu - 1]) lr += 1;
    if (x_scu + scuw < d->w_scu && d->cod[y_scu * d->w_scu + x_scu + scuw])
        lr += 2;
    return lr;
}

static void hist_update_v(DM *d, const int refi[2], const int mv[2][2],
                          int valid) {
    /* the reference keeps a stale slot when an affine center MV is
       invalid: the count still advances / the shifted tail keeps its old
       value (ref: src_main/xevdm.c:657-800) */
    if (d->hist_n == ALLOWED_CHECKED_NUM) {
        memmove(d->hist_refi[0], d->hist_refi[1],
                sizeof(d->hist_refi[0]) * (ALLOWED_CHECKED_NUM - 1));
        memmove(d->hist_mv[0], d->hist_mv[1],
                sizeof(d->hist_mv[0]) * (ALLOWED_CHECKED_NUM - 1));
        d->hist_n--;
        if (valid) {
            d->hist_refi[d->hist_n][0] = refi[0];
            d->hist_refi[d->hist_n][1] = refi[1];
            memcpy(d->hist_mv[d->hist_n], mv, sizeof(d->hist_mv[0]));
        }
        d->hist_n++;
    } else {
        if (valid) {
            d->hist_refi[d->hist_n][0] = refi[0];
            d->hist_refi[d->hist_n][1] = refi[1];
            memcpy(d->hist_mv[d->hist_n], mv, sizeof(d->hist_mv[0]));
        }
        d->hist_n++;
    }
}

static void hist_update(DM *d, const int refi[2], const int mv[2][2]) {
    hist_update_v(d, refi, mv, 1);
}

/* 5-position neighbor scan (ref: src_main/xevdm_util.c:594-744).
   neb[k] = scup index or -1 */
static void motion_availability(DM *d, int x_scu, int y_scu, int scuw,
                                int scuh, int avail_lr, int neb[5],
                                int valid[5]) {
    int W = d->w_scu, H = d->h_scu;
    int yb = y_scu + scuh - 1;
#define OKP(yy, xx) (d->cod[(yy) * W + (xx)] \
    && !d->map_if[(yy) * W + (xx)] && !d->map_ibc[(yy) * W + (xx)])
    if (avail_lr == LR_11) {
        int py[5] = {yb, yb, y_scu - 1, y_scu - 1, y_scu - 1};
        int px[5] = {x_scu - 1, x_scu + scuw, x_scu, x_scu + scuw,
                     x_scu - 1};
        int cond[5] = {x_scu > 0, x_scu + scuw < W, y_scu > 0,
                       y_scu > 0 && x_scu + scuw < W,
                       x_scu > 0 && y_scu > 0};
        for (int k = 0; k < 5; k++) {
            valid[k] = cond[k] && OKP(py[k], px[k]);
            neb[k] = py[k] * W + px[k];
        }
    } else if (avail_lr == LR_01) {
        int py[5] = {yb, y_scu - 1, y_scu - 1, y_scu + scuh, y_scu - 1};
        int px[5] = {x_scu + scuw, x_scu, x_scu - 1, x_scu + scuw,
                     x_scu + scuw};
        int cond[5] = {x_scu + scuw < W, y_scu > 0,
                       y_scu > 0 && x_scu > 0,
                       y_scu + scuh < H && x_scu + scuw < W,
                       y_scu > 0 && x_scu + scuw < W};
        for (int k = 0; k < 5; k++) {
            valid[k] = cond[k] && OKP(py[k], px[k]);
            neb[k] = py[k] * W + px[k];
        }
    } else {
        int py[5] = {yb, y_scu - 1, y_scu - 1, y_scu + scuh, y_scu - 1};
        int px[5] = {x_scu - 1, x_scu + scuw - 1, x_scu + scuw, x_scu - 1,
                     x_scu - 1};
        int cond[5] = {x_scu > 0, y_scu > 0,
                       y_scu > 0 && x_scu + scuw < W,
                       y_scu + scuh < H && x_scu > 0,
                       y_scu > 0 && x_scu > 0};
        for (int k = 0; k < 5; k++) {
            valid[k] = cond[k] && OKP(py[k], px[k]);
            neb[k] = py[k] * W + px[k];
        }
    }
#undef OKP
}

static int check_bi_app(int slice_type, int cuw, int cuh) {
    /* is_sps_admvp=1 call sites only (motion.py:163-166) */
    if (slice_type != SLICE_B) return 0;
    return cuw + cuh > 12;
}

typedef struct {
    int refi[2][MAXM_NUM_MVP];
    int mvp[2][MAXM_NUM_MVP][2];
} MergeList;

static void merge_insert(DM *d, MergeList *ml, int cnt,
                         const int src_refi[2], const int src_mv[2][2],
                         int cuw, int cuh) {
    /* (ref: src_main/xevdm_util.c xevdm_get_merge_insert_mv) */
    ml->refi[0][cnt] = src_refi[0] >= 0 ? src_refi[0] : REFI_INVALID;
    ml->mvp[0][cnt][0] = src_mv[0][0];
    ml->mvp[0][cnt][1] = src_mv[0][1];
    if (d->slice_type == SLICE_B) {
        if (src_refi[0] < 0) {
            ml->refi[1][cnt] = src_refi[1] >= 0 ? src_refi[1] : REFI_INVALID;
            ml->mvp[1][cnt][0] = src_mv[1][0];
            ml->mvp[1][cnt][1] = src_mv[1][1];
        } else if (!check_bi_app(d->slice_type, cuw, cuh)) {
            ml->refi[1][cnt] = REFI_INVALID;
            ml->mvp[1][cnt][0] = 0;
            ml->mvp[1][cnt][1] = 0;
        } else {
            ml->refi[1][cnt] = src_refi[1] >= 0 ? src_refi[1] : REFI_INVALID;
            ml->mvp[1][cnt][0] = src_mv[1][0];
            ml->mvp[1][cnt][1] = src_mv[1][1];
        }
    }
}

static int check_redundancy(DM *d, MergeList *ml, int cnt) {
    /* (ref: src_main/xevdm_util.c check_redundancy) */
    if (cnt > 0) {
        for (int i = cnt - 1; i >= 0; i--) {
            if (ml->refi[0][cnt] == ml->refi[0][i]
                && ml->mvp[0][cnt][0] == ml->mvp[0][i][0]
                && ml->mvp[0][cnt][1] == ml->mvp[0][i][1]) {
                if (d->slice_type != SLICE_B
                    || (ml->refi[1][cnt] == ml->refi[1][i]
                        && ml->mvp[1][cnt][0] == ml->mvp[1][i][0]
                        && ml->mvp[1][cnt][1] == ml->mvp[1][i][1]))
                    return cnt - 1;
            }
        }
    }
    return cnt;
}

static void clip_mv_pic(int x, int y, int max_x, int max_y, int mvp[2][2]) {
    /* (ref: src_main/xevdm_util.c:1417-1429) */
    for (int l = 0; l < 2; l++) {
        if (x + mvp[l][0] < -PIC_PAD_SIZE_L) mvp[l][0] = -(x - PIC_PAD_SIZE_L);
        if (y + mvp[l][1] < -PIC_PAD_SIZE_L) mvp[l][1] = -(y - PIC_PAD_SIZE_L);
        if (x + mvp[l][0] > max_x) mvp[l][0] = max_x - x;
        if (y + mvp[l][1] > max_y) mvp[l][1] = max_y - y;
    }
}

static int get_mv_collocated(DM *d, int scup_y, int scup_x, int c_y, int c_x,
                             int mvp[2][2]) {
    /* (ref: src_main/xevdm_util.c:3729-3820); returns avail bits */
    mvp[0][0] = mvp[0][1] = mvp[1][0] = mvp[1][1] = 0;
    if (!d->col_refi) return 0;
    int W = d->w_scu;
    int ver_refi[2] = {-1, -1};
    int dpoc[2];
    dpoc[0] = d->p[D_NUM_REFP0] > 0 ? d->poc - d->refp_poc[0][0] : 0;
    dpoc[1] = d->p[D_NUM_REFP1] > 0 ? d->poc - d->refp_poc[1][0] : 0;
    int scup = scup_y * W + scup_x;
    if (!d->p[D_TMVP_ASSIGNED]) {
        for (int lidx = 0; lidx < 2; lidx++) {
            int refidx = d->col_refi[scup * 2 + lidx];
            if (refidx >= 0) {
                int dpoc_co = d->col_poc - d->col_list_poc[refidx];
                if (dpoc_co != 0) {
                    long long ratio = c_div(
                        (long long)dpoc[lidx] << MVP_SCALING_PRECISION,
                        dpoc_co);
                    ver_refi[lidx] = 0;
                    int mvc[2] = {d->col_mv[(scup * 2 + lidx) * 2],
                                  d->col_mv[(scup * 2 + lidx) * 2 + 1]};
                    scaling_mv(ratio, mvc, mvp[lidx]);
                }
            }
        }
    } else {
        int src = d->p[D_COL_SRC_LIST];
        int refidx = d->col_refi[scup * 2 + src];
        int dpoc_co = 0;
        if (refidx >= 0) dpoc_co = d->col_poc - d->col_list_poc[refidx];
        if (dpoc_co != 0) {
            ver_refi[0] = ver_refi[1] = 0;
            int mvc[2] = {d->col_mv[(scup * 2 + src) * 2],
                          d->col_mv[(scup * 2 + src) * 2 + 1]};
            scaling_mv(c_div((long long)dpoc[0] << MVP_SCALING_PRECISION,
                             dpoc_co), mvc, mvp[0]);
            scaling_mv(c_div((long long)dpoc[1] << MVP_SCALING_PRECISION,
                             dpoc_co), mvc, mvp[1]);
        }
    }
    int max_x = PIC_PAD_SIZE_L + (d->w_scu << 2) - 1;
    int max_y = PIC_PAD_SIZE_L + (d->h_scu << 2) - 1;
    clip_mv_pic(c_x << 2, c_y << 2, max_x, max_y, mvp);
    return (ver_refi[0] >= 0 ? 1 : 0) + (ver_refi[1] >= 0 ? 2 : 0);
}

static int right_below_scup_merge(DM *d, int x_scu, int y_scu, int scuw,
                                  int scuh, int bottom_right, int suco,
                                  int *oy, int *ox) {
    /* (ref: src_main/xevdm_util.c:1001-1057); returns 0 if unavailable */
    int log2_ctu = d->p[D_LOG2_CTU];
    if (suco) {
        int xb = x_scu - 1;
        int yb = y_scu + scuh - 1;
        if (bottom_right == 0) {
            if (yb + 1 >= d->h_scu) return 0;
            if ((((yb + 1) << 2) >> log2_ctu) != ((yb << 2) >> log2_ctu))
                return 0;
            *oy = ((yb + 1) >> 1) << 1;
            *ox = ((xb + 1) >> 1) << 1;
            return 1;
        }
        if (xb < 0) return 0;
        if ((((xb + 1) << 2) >> log2_ctu) != ((xb << 2) >> log2_ctu))
            return 0;
        *oy = (yb >> 1) << 1;
        *ox = (xb >> 1) << 1;
        return 1;
    }
    int xb = x_scu + scuw - 1;
    int yb = y_scu + scuh - 1;
    if (bottom_right == 0) {
        if (yb + 1 >= d->h_scu) return 0;
        if ((((yb + 1) << 2) >> log2_ctu) != ((yb << 2) >> log2_ctu))
            return 0;
        *oy = ((yb + 1) >> 1) << 1;
        *ox = (xb >> 1) << 1;
        return 1;
    }
    if (xb + 1 >= d->w_scu) return 0;
    if ((((xb + 1) << 2) >> log2_ctu) != ((xb << 2) >> log2_ctu)) return 0;
    *oy = (yb >> 1) << 1;
    *ox = ((xb + 1) >> 1) << 1;
    return 1;
}

static void get_motion_merge_main(DM *d, int x_scu, int y_scu, int cuw,
                                  int cuh, int avail_lr, MergeList *ml) {
    /* (ref: src_main/xevdm_util.c:1169-1405) */
    int scuw = cuw >> 2, scuh = cuh >> 2;
    int small_cu = cuw * cuh <= NUM_SAMPLES_BLOCK;
    int max_cand = small_cu ? MAX_NUM_MVP_SMALL_CU : MAXM_NUM_MVP;
    for (int l = 0; l < 2; l++)
        for (int k = 0; k < MAXM_NUM_MVP; k++) {
            ml->refi[l][k] = REFI_INVALID;
            ml->mvp[l][k][0] = ml->mvp[l][k][1] = 0;
        }
    int cnt = 0;
    int neb[5], valid[5];
    motion_availability(d, x_scu, y_scu, scuw, scuh, avail_lr, neb, valid);
    for (int k = 0; k < 5; k++) {
        if (valid[k]) {
            int p = neb[k];
            int sr[2] = {d->map_refi[p * 2], d->map_refi[p * 2 + 1]};
            int sm[2][2] = {{d->map_mv[p * 4], d->map_mv[p * 4 + 1]},
                            {d->map_mv[p * 4 + 2], d->map_mv[p * 4 + 3]}};
            merge_insert(d, ml, cnt, sr, sm, cuw, cuh);
            cnt = check_redundancy(d, ml, cnt);
            cnt++;
        }
        if (cnt == max_cand - 1) break;
    }

    /* TMVP: central 8x8-aligned, then bottom, then right */
    int done = 0;
    {
        int cy = ((y_scu + (scuh >> 1)) >> 1) << 1;
        int cx = ((x_scu + (scuw >> 1)) >> 1) << 1;
        int tmvp[2][2];
        int avail = get_mv_collocated(d, cy, cx, y_scu, x_scu, tmvp);
        if (avail) {
            int refs[2] = {(avail == 1 || avail == 3) ? 0 : -1,
                           (avail == 2 || avail == 3) ? 0 : -1};
            int before = cnt;
            merge_insert(d, ml, cnt, refs, tmvp, cuw, cuh);
            cnt = check_redundancy(d, ml, cnt);
            cnt++;
            done = (cnt == before + 1);
            if (cnt >= max_cand) return;
        }
    }
    int suco = avail_lr == LR_01;
    for (int br = 0; br < 2 && !done; br++) {
        int py, px;
        if (!right_below_scup_merge(d, x_scu, y_scu, scuw, scuh, br, suco,
                                    &py, &px))
            continue;
        int tmvp[2][2];
        int avail = get_mv_collocated(d, py, px, y_scu, x_scu, tmvp);
        if (avail) {
            int refs[2] = {(avail == 1 || avail == 3) ? 0 : -1,
                           (avail == 2 || avail == 3) ? 0 : -1};
            int before = cnt;
            merge_insert(d, ml, cnt, refs, tmvp, cuw, cuh);
            cnt = check_redundancy(d, ml, cnt);
            cnt++;
            done = (cnt == before + 1);
            if (cnt >= max_cand) return;
        }
    }

    /* HMVP candidates: every 4th entry from the newest-3 back */
    if (cnt < max_cand) {
        int lim = d->hist_n;
        int cap = small_cu ? ALLOWED_CHECKED_NUM_SMALL_CU
                           : ALLOWED_CHECKED_NUM;
        if (lim > cap) lim = cap;
        for (int k = 3; k <= lim; k += 4) {
            int hi = d->hist_n - k;
            merge_insert(d, ml, cnt, d->hist_refi[hi],
                         (const int (*)[2])d->hist_mv[hi], cuw, cuh);
            cnt = check_redundancy(d, ml, cnt);
            cnt++;
            if (cnt >= max_cand) return;
        }
    }

    /* pairwise L0/L1 combinations */
    if (check_bi_app(d->slice_type, cuw, cuh)) {
        static const int pri0[20] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3,
                                     2, 3, 0, 4, 1, 4, 2, 4, 3, 4};
        static const int pri1[20] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1,
                                     3, 2, 4, 0, 4, 1, 4, 2, 4, 3};
        int cur = cnt;
        for (int i = 0; i < cur * (cur - 1) && cnt != max_cand && i < 20;
             i++) {
            int i0 = pri0[i], i1 = pri1[i];
            if (ml->refi[0][i0] >= 0 && ml->refi[1][i1] >= 0) {
                ml->refi[0][cnt] = ml->refi[0][i0];
                ml->mvp[0][cnt][0] = ml->mvp[0][i0][0];
                ml->mvp[0][cnt][1] = ml->mvp[0][i0][1];
                ml->refi[1][cnt] = ml->refi[1][i1];
                ml->mvp[1][cnt][0] = ml->mvp[1][i1][0];
                ml->mvp[1][cnt][1] = ml->mvp[1][i1][1];
                cnt++;
            }
        }
        if (cnt == max_cand) return;
    }

    int bi_ok = check_bi_app(d->slice_type, cuw, cuh);
    for (int k = cnt; k < max_cand; k++) {
        ml->refi[0][k] = 0;
        ml->mvp[0][k][0] = ml->mvp[0][k][1] = 0;
        ml->refi[1][k] = bi_ok ? 0 : REFI_INVALID;
        ml->mvp[1][k][0] = ml->mvp[1][k][1] = 0;
    }
}

static void get_default_motion(DM *d, const int neb[5], const int valid[5],
                               int cur_refi, int lidx, int hmvp_flag,
                               int *out_refi, int out_mv[2]) {
    /* (ref: src_main/xevdm_util.c:771-868) */
    int refi = 0, found = 0;
    int mv[2] = {0, 0};
    for (int k = 0; k < 2 && !found; k++) {
        if (valid[k]) {
            int t = d->map_refi[neb[k] * 2 + lidx];
            if (t == cur_refi) {
                found = 1;
                refi = t;
                mv[0] = d->map_mv[(neb[k] * 2 + lidx) * 2];
                mv[1] = d->map_mv[(neb[k] * 2 + lidx) * 2 + 1];
            }
        }
    }
    if (!found) {
        for (int k = 0; k < 2 && !found; k++) {
            if (valid[k]) {
                int t = d->map_refi[neb[k] * 2 + lidx];
                if (t >= 0) {
                    found = 1;
                    refi = t;
                    mv[0] = d->map_mv[(neb[k] * 2 + lidx) * 2];
                    mv[1] = d->map_mv[(neb[k] * 2 + lidx) * 2 + 1];
                }
            }
        }
    }
    if (hmvp_flag) {
        int lim = d->hist_n < ALLOWED_CHECKED_AMVP_NUM
                  ? d->hist_n : ALLOWED_CHECKED_AMVP_NUM;
        if (!found) {
            for (int k = 1; k <= lim && !found; k++) {
                int hi = d->hist_n - k;
                if (d->hist_refi[hi][lidx] == cur_refi) {
                    found = 1;
                    refi = d->hist_refi[hi][lidx];
                    mv[0] = d->hist_mv[hi][lidx][0];
                    mv[1] = d->hist_mv[hi][lidx][1];
                }
            }
        }
        if (!found) {
            for (int k = 1; k <= lim && !found; k++) {
                int hi = d->hist_n - k;
                if (d->hist_refi[hi][lidx] >= 0) {
                    found = 1;
                    refi = d->hist_refi[hi][lidx];
                    mv[0] = d->hist_mv[hi][lidx][0];
                    mv[1] = d->hist_mv[hi][lidx][1];
                }
            }
        }
    }
    *out_refi = refi;
    out_mv[0] = mv[0];
    out_mv[1] = mv[1];
}

static void get_motion_from_mvr(DM *d, int mvr_idx, int x_scu, int y_scu,
                                int lidx, int cur_refi, int num_refp,
                                int cuw, int cuh, int avail_lr,
                                int hmvp_flag, int out[2]) {
    /* (ref: src_main/xevdm_util.c:869-1000) */
    int scuw = cuw >> 2, scuh = cuh >> 2;
    int rounding = mvr_idx > 0 ? (1 << (mvr_idx - 1)) : 0;
    int neb[5], valid[5];
    motion_availability(d, x_scu, y_scu, scuw, scuh, avail_lr, neb, valid);
    int default_refi, default_mv[2];
    get_default_motion(d, neb, valid, cur_refi, lidx, hmvp_flag,
                       &default_refi, default_mv);
    int poc_refi_cur = d->refp_poc[lidx][cur_refi];
    long long ratio[MAX_REFP];
    for (int i = 0; i < num_refp; i++) {
        int t0 = d->poc - d->refp_poc[lidx][i];
        ratio[i] = c_div((long long)(d->poc - poc_refi_cur)
                         << MVP_SCALING_PRECISION, t0);
    }
    int mvp_t[2];
    if (valid[mvr_idx]) {
        int p = neb[mvr_idx];
        int refi0 = d->map_refi[p * 2 + lidx];
        if (refi0 == cur_refi) {
            mvp_t[0] = d->map_mv[(p * 2 + lidx) * 2];
            mvp_t[1] = d->map_mv[(p * 2 + lidx) * 2 + 1];
        } else if (refi0 < 0) {
            refi0 = default_refi;
            if (refi0 == cur_refi) {
                mvp_t[0] = default_mv[0];
                mvp_t[1] = default_mv[1];
            } else {
                scaling_mv(ratio[refi0], default_mv, mvp_t);
            }
        } else {
            int nm[2] = {d->map_mv[(p * 2 + lidx) * 2],
                         d->map_mv[(p * 2 + lidx) * 2 + 1]};
            scaling_mv(ratio[refi0], nm, mvp_t);
        }
    } else {
        int refi0 = default_refi;
        if (refi0 == cur_refi) {
            mvp_t[0] = default_mv[0];
            mvp_t[1] = default_mv[1];
        } else {
            scaling_mv(ratio[refi0], default_mv, mvp_t);
        }
    }
    for (int dd = 0; dd < 2; dd++) {
        int v = mvp_t[dd];
        out[dd] = v >= 0 ? (((v + rounding) >> mvr_idx) << mvr_idx)
                         : -((((-v) + rounding) >> mvr_idx) << mvr_idx);
    }
}

static int get_first_refi(DM *d, int x_scu, int y_scu, int cuw, int cuh,
                          int lidx, int mvr_idx, int avail_lr,
                          int hmvp_flag) {
    /* (ref: src_main/xevdm_util.c:745-770) */
    int neb[5], valid[5];
    motion_availability(d, x_scu, y_scu, cuw >> 2, cuh >> 2, avail_lr,
                       neb, valid);
    int default_refi, dmv[2];
    get_default_motion(d, neb, valid, 0, lidx, hmvp_flag, &default_refi,
                       dmv);
    if (valid[mvr_idx]) {
        int t = d->map_refi[neb[mvr_idx] * 2 + lidx];
        return t >= 0 ? t : default_refi;
    }
    return default_refi;
}

static const int MMVD_REF_CANDS[8] = {1, 2, 4, 8, 16, 32, 64, 128};

static void get_mmvd_motion(DM *d, int mmvd_idx, int x_scu, int y_scu,
                            int cuw, int cuh, int avail_lr,
                            int out_refi[2], int out_mv[2][2]) {
    /* (ref: src_main/xevdm_util.c:192-593, selection :4682-4717) */
    int group = mmvd_idx >> 7;
    int base_idx = (mmvd_idx & 127) >> 5;
    int kref = mmvd_idx & 31;
    int small_cu = cuw * cuh <= NUM_SAMPLES_BLOCK;
    int prec = MVP_SCALING_PRECISION;
    int poc = d->poc;

    MergeList ml;
    get_motion_merge_main(d, x_scu, y_scu, cuw, cuh, avail_lr, &ml);
    int REF_SET[2][5];
    for (int l = 0; l < 2; l++)
        for (int i = 0; i < 5; i++)
            REF_SET[l][i] = d->refp_poc[l][i];

    int base[2][3], bt[2][3];
    if (d->slice_type == SLICE_B) {
        base[0][0] = ml.mvp[0][base_idx][0];
        base[0][1] = ml.mvp[0][base_idx][1];
        base[0][2] = ml.refi[0][base_idx];
        base[1][0] = ml.mvp[1][base_idx][0];
        base[1][1] = ml.mvp[1][base_idx][1];
        base[1][2] = ml.refi[1][base_idx];
    } else {
        base[0][0] = ml.mvp[0][base_idx][0];
        base[0][1] = ml.mvp[0][base_idx][1];
        base[0][2] = ml.refi[0][base_idx];
        base[1][0] = ml.mvp[1][0][0];
        base[1][1] = ml.mvp[1][0][1];
        base[1][2] = ml.refi[1][0];
    }
    memcpy(bt, base, sizeof(base));
    int base_p[3][3];
    memset(base_p, 0, sizeof(base_p));
    int r0 = bt[0][2], r1 = bt[1][2];
    int base_type[3];

#define SCALE_ABS(wgt, v, sign) \
    s16c((sign) * ((((wgt) * (v) < 0 ? -((long long)(wgt) * (v)) \
                                     : (long long)(wgt) * (v)) \
                    + (1 << (prec - 1))) >> prec))

    if (r0 >= 0 && r1 >= 0) {
        base_type[0] = 0; base_type[1] = 1; base_type[2] = 2;
    } else if (r0 >= 0 && r1 < 0) {
        if (d->slice_type == SLICE_P) {
            base_type[0] = base_type[1] = base_type[2] = 1;
            int nref = d->p[D_NUM_REFP0];
            if (nref == 1) {
                base_p[0][0] = bt[0][0]; base_p[0][1] = bt[0][1];
                base_p[0][2] = bt[0][2];
                base_p[1][0] = bt[0][0] + 3; base_p[1][1] = bt[0][1];
                base_p[1][2] = bt[0][2];
                base_p[2][0] = bt[0][0] - 3; base_p[2][1] = bt[0][1];
                base_p[2][2] = bt[0][2];
            } else {
                int ref_b0 = bt[0][2];
                int ref_b1 = bt[0][2] ? 0 : 1;
                int ref_b2 = nref < 3 ? bt[0][2] : (bt[0][2] < 2 ? 2 : 1);
                base_p[0][0] = bt[0][0]; base_p[0][1] = bt[0][1];
                base_p[0][2] = ref_b0;
                long long w1 = c_div(
                    (long long)(poc - REF_SET[0][ref_b0]) << prec,
                    poc - REF_SET[0][ref_b1]);
                base_p[1][0] = SCALE_ABS(w1, bt[0][0], 1);
                base_p[1][1] = SCALE_ABS(w1, bt[0][1], 1);
                base_p[1][2] = ref_b1;
                if (nref == 2) {
                    base_p[2][0] = bt[0][0] - 3; base_p[2][1] = bt[0][1];
                    base_p[2][2] = ref_b2;
                } else {
                    long long w2 = c_div(
                        (long long)(poc - REF_SET[0][ref_b0]) << prec,
                        poc - REF_SET[0][ref_b2]);
                    base_p[2][0] = SCALE_ABS(w2, bt[0][0], 1);
                    base_p[2][1] = SCALE_ABS(w2, bt[0][1], 1);
                    base_p[2][2] = ref_b2;
                }
            }
        } else {
            base_type[0] = 1; base_type[1] = 0; base_type[2] = 2;
            int poc0 = REF_SET[0][r0];
            if (d->p[D_NUM_REFP1] > 1 && (REF_SET[1][1] - poc) == (poc - poc0))
                bt[1][2] = 1;
            else
                bt[1][2] = 0;
            int poc1 = REF_SET[1][bt[1][2]];
            long long w = c_div((long long)(poc - poc1) << prec, poc - poc0);
            int ref_sign = (w * bt[0][0] < 0) ? -1 : 1;
            bt[1][0] = SCALE_ABS(w, bt[0][0], ref_sign);
            int ref_sign1 = (w * bt[0][1] < 0) ? -1 : 1;
            bt[1][1] = SCALE_ABS(w, bt[0][1], ref_sign1);
        }
    } else if (r0 < 0 && r1 >= 0) {
        base_type[0] = 2; base_type[1] = 0; base_type[2] = 1;
        int poc1 = REF_SET[1][r1];
        if (d->p[D_NUM_REFP0] > 1 && (REF_SET[0][1] - poc) == (poc - poc1))
            bt[0][2] = 1;
        else
            bt[0][2] = 0;
        int poc0 = REF_SET[0][bt[0][2]];
        long long w = c_div((long long)(poc - poc0) << prec, poc - poc1);
        int ref_sign = (w * bt[1][0] < 0) ? -1 : 1;
        bt[0][0] = SCALE_ABS(w, bt[1][0], ref_sign);
        int ref_sign1 = (w * bt[1][1] < 0) ? -1 : 1;
        bt[0][1] = SCALE_ABS(w, bt[1][1], ref_sign1);
    } else {
        base_type[0] = base_type[1] = base_type[2] = 3;
    }

    if (small_cu) base_type[0] = 1;

    /* one-sided types keep the other list's original merge MV (stale value
       flows into maps/history — deliberate reference behavior) */
    int bm[2][3];
    int t = base_type[group];
    if (t == 0) {
        memcpy(bm, bt, sizeof(bt));
    } else if (t == 1) {
        if (d->slice_type == SLICE_P) {
            bm[0][0] = base_p[group][0]; bm[0][1] = base_p[group][1];
            bm[0][2] = base_p[group][2];
            bm[1][0] = base[1][0]; bm[1][1] = base[1][1]; bm[1][2] = -1;
        } else {
            memcpy(bm[0], bt[0], sizeof(bt[0]));
            bm[1][0] = base[1][0]; bm[1][1] = base[1][1]; bm[1][2] = -1;
        }
    } else if (t == 2) {
        bm[0][0] = base[0][0]; bm[0][1] = base[0][1]; bm[0][2] = -1;
        memcpy(bm[1], bt[1], sizeof(bt[1]));
    } else {
        bm[0][0] = base[0][0]; bm[0][1] = base[0][1]; bm[0][2] = -1;
        bm[1][0] = base[1][0]; bm[1][1] = base[1][1]; bm[1][2] = -1;
    }

    int l0r = bm[0][2], l1r = bm[1][2];
    int ref_sign = 1;
    if (d->slice_type == SLICE_B && l0r != -1 && l1r != -1) {
        int poc0 = REF_SET[0][l0r], poc1 = REF_SET[1][l1r];
        if ((long long)(poc0 - poc) * (poc - poc1) > 0) ref_sign = -1;
    }

    int cand = MMVD_REF_CANDS[kref >> 2];
    int ref_mvd = cand, ref_mvd1 = cand;
    if (l0r != -1 && l1r != -1) {
        int poc0 = REF_SET[0][l0r], poc1 = REF_SET[1][l1r];
        int a0 = poc0 - poc < 0 ? poc - poc0 : poc0 - poc;
        int a1 = poc1 - poc < 0 ? poc - poc1 : poc1 - poc;
        if (a1 >= a0) {
            long long w = c_div((long long)a0 << prec, a1);
            ref_mvd = s16c((w * cand + (1 << (prec - 1))) >> prec);
        } else {
            long long w = c_div((long long)a1 << prec, a0);
            ref_mvd1 = s16c((w * cand + (1 << (prec - 1))) >> prec);
        }
    }

    int km = kref & 3;
    int h0, h1, v0, v1;
    if (km == 0) { h0 = ref_mvd; h1 = ref_mvd1 * ref_sign; v0 = v1 = 0; }
    else if (km == 1) { h0 = -ref_mvd; h1 = -ref_mvd1 * ref_sign;
                        v0 = v1 = 0; }
    else if (km == 2) { h0 = h1 = 0; v0 = ref_mvd; v1 = ref_mvd1 * ref_sign; }
    else { h0 = h1 = 0; v0 = -ref_mvd; v1 = -ref_mvd1 * ref_sign; }

    out_mv[0][0] = bm[0][0] + h0;
    out_mv[0][1] = bm[0][1] + v0;
    out_mv[1][0] = bm[1][0] + h1;
    out_mv[1][1] = bm[1][1] + v1;
    out_refi[0] = bm[0][2];
    out_refi[1] = bm[1][2];
    if (d->slice_type == SLICE_P) out_refi[1] = REFI_INVALID;
#undef SCALE_ABS
}

/* baseline 4-candidate MVP (ref: src_base/xevd_util.c:469-515) */
static void mvp_candidates_b(DM *d, int lidx, int x_scu, int y_scu,
                             int scuw, int avail, int mvp[4][2]) {
    for (int k = 0; k < 4; k++) mvp[k][0] = mvp[k][1] = 1;
    int W = d->w_scu;
    if (avail & 2) {   /* AVAIL_LE */
        const int16_t *p = d->map_mv + ((y_scu * W + x_scu - 1) * 2
                                        + lidx) * 2;
        mvp[0][0] = p[0]; mvp[0][1] = p[1];
    }
    if (avail & 1) {   /* AVAIL_UP */
        const int16_t *p = d->map_mv + (((y_scu - 1) * W + x_scu) * 2
                                        + lidx) * 2;
        mvp[1][0] = p[0]; mvp[1][1] = p[1];
    }
    if (avail & 4) {   /* AVAIL_UP_RI */
        const int16_t *p = d->map_mv + (((y_scu - 1) * W + x_scu + scuw) * 2
                                        + lidx) * 2;
        mvp[2][0] = p[0]; mvp[2][1] = p[1];
    }
    const int16_t *rm = lidx == 0 ? d->r00_mv : d->r01_mv;
    if (rm) {
        const int16_t *p = rm + ((y_scu * W + x_scu) * 2 + 0) * 2;
        mvp[3][0] = p[0]; mvp[3][1] = p[1];
    } else {
        mvp[3][0] = mvp[3][1] = 0;
    }
}

static int htdf_skip_and_idx(int w, int h, int intra, int qp) {
    /* (ref: src_main/xevdm_recon.c:274-305; tables.py:586-597) */
    int mx = w > h ? w : h, mn = w < h ? w : h;
    if (qp <= 17 || w * h < 64 || mx >= 128) return -1;
    if (!intra) {
        if (mn >= 32) return -1;
    } else if (w == h && mn >= 32) {
        qp -= 8;
    }
    int idx = (qp - 20 + 4) >> 3;
    if (idx < 0) idx = 0;
    if (idx > 4) idx = 4;
    return idx;
}

/* ------------------------------------------------------------------ */
/* Affine candidate machinery (port of xevd_tpu/affine.py; ref:
   src_main/xevdm_util.c:1870-3189, xevdm.c:938-1040)                  */
/* ------------------------------------------------------------------ */
#define VER_NUM 4
#define AFF_MAX_CAND 5
#define AFF_MODEL_CAND 5
#define AFF_MAX_NUM_MVP 2
#define LR_10 1

static int tbl_log2i(int v) {
    int r = 0;
    while (v > 1) { v >>= 1; r++; }
    return r;
}

static void aff_mv_rounding(long long hor, long long ver, int right_shift,
                            int *oh, int *ov) {
    long long offset = right_shift > 0 ? (1LL << (right_shift - 1)) : 0;
    *oh = (int)((hor + offset - (hor >= 0)) >> right_shift);
    *ov = (int)((ver + offset - (ver >= 0)) >> right_shift);
}

static void aff_model_params(const int ac_mv[VER_NUM][2], int cuw, int cuh,
                             int vertex_num, int prec, int d_hor[2],
                             int d_ver[2]) {
    int lw = tbl_log2i(cuw), lh = tbl_log2i(cuh);
    for (int c = 0; c < 2; c++)
        d_hor[c] = ((ac_mv[1][c] - ac_mv[0][c]) << prec) >> lw;
    if (vertex_num == 3) {
        for (int c = 0; c < 2; c++)
            d_ver[c] = ((ac_mv[2][c] - ac_mv[0][c]) << prec) >> lh;
    } else {
        d_ver[0] = -d_hor[1];
        d_ver[1] = d_hor[0];
    }
}

/* derive_affine_model_mv: inherited CPMVs from an affine neighbor */
static void aff_model_mv(DM *d, int cy, int cx, int ny, int nx, int lidx,
                         int cuw, int cuh, int cur_cp_num,
                         int log2_max_cuwh, int mvp[3][2]) {
    int W = d->w_scu;
    int nl_w = d->am_logw[ny * W + nx];
    int nl_h = d->am_logh[ny * W + nx];
    int neb_w = 1 << nl_w, neb_h = 1 << nl_h;
    int by = ny - d->am_yoff[ny * W + nx];
    int bx = nx - d->am_xoff[ny * W + nx];
    int addr[4][2] = {
        {by, bx}, {by, bx + (neb_w >> 2) - 1},
        {by + (neb_h >> 2) - 1, bx},
        {by + (neb_h >> 2) - 1, bx + (neb_w >> 2) - 1}};
    int neb_mv[4][2];
    for (int i = 0; i < 4; i++) {
        int p = addr[i][0] * W + addr[i][1];
        neb_mv[i][0] = d->map_mv[(p * 2 + lidx) * 2];
        neb_mv[i][1] = d->map_mv[(p * 2 + lidx) * 2 + 1];
    }
    int neb_x = bx << 2, neb_y = by << 2;
    int cur_x = cx << 2, cur_y = cy << 2;
    int max_bit = 7;
    int diff_w = max_bit - nl_w, diff_h = max_bit - nl_h;
    int top_bound = 0;
    if ((neb_y + neb_h) % (1 << log2_max_cuwh) == 0
        && (neb_y + neb_h) == cur_y) {
        top_bound = 1;
        neb_y += neb_h;
        neb_mv[0][0] = neb_mv[2][0]; neb_mv[0][1] = neb_mv[2][1];
        neb_mv[1][0] = neb_mv[3][0]; neb_mv[1][1] = neb_mv[3][1];
    }
    int dhx = (neb_mv[1][0] - neb_mv[0][0]) << diff_w;
    int dhy = (neb_mv[1][1] - neb_mv[0][1]) << diff_w;
    int dvx, dvy;
    if (cur_cp_num == 3 && !top_bound) {
        dvx = (neb_mv[2][0] - neb_mv[0][0]) << diff_h;
        dvy = (neb_mv[2][1] - neb_mv[0][1]) << diff_h;
    } else {
        dvx = -dhy;
        dvy = dhx;
    }
    long long hor_base = (long long)neb_mv[0][0] << max_bit;
    long long ver_base = (long long)neb_mv[0][1] << max_bit;
    int pts[3][2] = {{cur_x - neb_x, cur_y - neb_y},
                     {cur_x - neb_x + cuw, cur_y - neb_y},
                     {cur_x - neb_x, cur_y - neb_y + cuh}};
    int n = cur_cp_num == 3 ? 3 : 2;
    mvp[2][0] = mvp[2][1] = 0;
    for (int i = 0; i < n; i++) {
        long long th = (long long)dhx * pts[i][0]
                       + (long long)dvx * pts[i][1] + hor_base;
        long long tv = (long long)dhy * pts[i][0]
                       + (long long)dvy * pts[i][1] + ver_base;
        int h, v;
        aff_mv_rounding(th, tv, max_bit, &h, &v);
        mvp[i][0] = s16c(h);
        mvp[i][1] = s16c(v);
    }
}

#define COD_OK(d, y, x) \
    ((d)->cod[(y) * (d)->w_scu + (x)] \
     && !(d)->map_if[(y) * (d)->w_scu + (x)])
#define AFF_OK(d, y, x) \
    (COD_OK(d, y, x) && (d)->am_aff[(y) * (d)->w_scu + (x)] != 0)

/* constructed candidate (ref: xevdm_derive_affine_constructed_candidate) */
static int aff_constructed(int cuw, int cuh, const int cp_valid[VER_NUM],
                           int cp_mv[2][VER_NUM][2],
                           const int cp_refi[2][VER_NUM],
                           const int *cp_idx, int model_idx, int ver_num,
                           int cpmv[AFF_MAX_CAND][2][3][2],
                           int refi_l[AFF_MAX_CAND][2], int cnt,
                           int cp_num[AFF_MAX_CAND]) {
    if (cnt >= AFF_MAX_CAND) return cnt;
    int shift_htow = 7 + tbl_log2i(cuw) - tbl_log2i(cuh);
    int valid_model[2] = {0, 0};
    for (int i = 0; i < ver_num; i++)
        if (!cp_valid[cp_idx[i]]) return cnt;
    for (int lidx = 0; lidx < 2; lidx++) {
        int ok = 1, r0 = cp_refi[lidx][cp_idx[0]];
        if (r0 < 0) ok = 0;
        for (int i = 1; i < ver_num && ok; i++)
            if (cp_refi[lidx][cp_idx[i]] != r0
                || cp_refi[lidx][cp_idx[i]] < 0) ok = 0;
        valid_model[lidx] = ok;
    }
    if (!valid_model[0] && !valid_model[1]) return cnt;
    cp_num[cnt] = ver_num;
    for (int lidx = 0; lidx < 2; lidx++) {
        if (valid_model[lidx]) {
            refi_l[cnt][lidx] = cp_refi[lidx][cp_idx[0]];
            long long tmp[VER_NUM][2];
            for (int i = 0; i < VER_NUM; i++) {
                tmp[i][0] = cp_mv[lidx][i][0];
                tmp[i][1] = cp_mv[lidx][i][1];
            }
            if (model_idx == 1) {
                tmp[2][0] = tmp[3][0] + tmp[0][0] - tmp[1][0];
                tmp[2][1] = tmp[3][1] + tmp[0][1] - tmp[1][1];
            } else if (model_idx == 2) {
                tmp[1][0] = tmp[3][0] + tmp[0][0] - tmp[2][0];
                tmp[1][1] = tmp[3][1] + tmp[0][1] - tmp[2][1];
            } else if (model_idx == 3) {
                tmp[0][0] = tmp[1][0] + tmp[2][0] - tmp[3][0];
                tmp[0][1] = tmp[1][1] + tmp[2][1] - tmp[3][1];
            } else if (model_idx == 5) {
                long long th = ((tmp[2][1] - tmp[0][1]) << shift_htow)
                               + (tmp[0][0] << 7);
                long long tv = -((tmp[2][0] - tmp[0][0]) << shift_htow)
                               + (tmp[0][1] << 7);
                int h, v;
                aff_mv_rounding(th, tv, 7, &h, &v);
                tmp[1][0] = h;
                tmp[1][1] = v;
            }
            for (int i = 0; i < ver_num; i++) {
                cpmv[cnt][lidx][i][0] = s16c(tmp[i][0]);
                cpmv[cnt][lidx][i][1] = s16c(tmp[i][1]);
            }
        } else {
            refi_l[cnt][lidx] = REFI_INVALID;
            for (int i = 0; i < ver_num; i++) {
                cpmv[cnt][lidx][i][0] = 0;
                cpmv[cnt][lidx][i][1] = 0;
            }
        }
    }
    return cnt + 1;
}

/* affine merge list (ref: xevdm_get_affine_merge_candidate) */
static void aff_merge_candidates(DM *d, int x_scu, int y_scu, int cuw,
                                 int cuh, int avail_lr, int log2_max_cuwh,
                                 int refi_l[AFF_MAX_CAND][2],
                                 int cpmv[AFF_MAX_CAND][2][3][2],
                                 int cp_num[AFF_MAX_CAND]) {
    int W = d->w_scu, H = d->h_scu;
    int scuw = cuw >> 2, scuh = cuh >> 2;
    int cnt = 0;
    for (int k = 0; k < AFF_MAX_CAND; k++) {
        refi_l[k][0] = refi_l[k][1] = REFI_INVALID;
        cp_num[k] = 2;
        memset(cpmv[k], 0, sizeof(cpmv[k]));
    }
    /* model based (inherited) */
    int neb[5][2], valid[5];
    if (avail_lr == LR_01) {
        int tmp[5][2] = {{y_scu + scuh - 1, x_scu + scuw},
                         {y_scu - 1, x_scu},
                         {y_scu - 1, x_scu - 1},
                         {y_scu + scuh, x_scu + scuw},
                         {y_scu - 1, x_scu + scuw}};
        memcpy(neb, tmp, sizeof(tmp));
        valid[0] = x_scu + scuw < W && AFF_OK(d, neb[0][0], neb[0][1]);
        valid[1] = y_scu > 0 && AFF_OK(d, neb[1][0], neb[1][1]);
        valid[2] = x_scu > 0 && y_scu > 0 && AFF_OK(d, neb[2][0], neb[2][1]);
        valid[3] = x_scu + scuw < W && y_scu + scuh < H
                   && AFF_OK(d, neb[3][0], neb[3][1]);
        valid[4] = y_scu > 0 && x_scu + scuw < W
                   && AFF_OK(d, neb[4][0], neb[4][1]);
    } else {
        int tmp[5][2] = {{y_scu + scuh - 1, x_scu - 1},
                         {y_scu - 1, x_scu + scuw - 1},
                         {y_scu - 1, x_scu + scuw},
                         {y_scu + scuh, x_scu - 1},
                         {y_scu - 1, x_scu - 1}};
        memcpy(neb, tmp, sizeof(tmp));
        valid[0] = x_scu > 0 && AFF_OK(d, neb[0][0], neb[0][1]);
        valid[1] = y_scu > 0 && AFF_OK(d, neb[1][0], neb[1][1]);
        valid[2] = y_scu > 0 && x_scu + scuw < W
                   && AFF_OK(d, neb[2][0], neb[2][1]);
        valid[3] = x_scu > 0 && y_scu + scuh < H
                   && AFF_OK(d, neb[3][0], neb[3][1]);
        valid[4] = x_scu > 0 && y_scu > 0 && AFF_OK(d, neb[4][0], neb[4][1]);
    }
    long long top_left[5];
    for (int k = 0; k < 5; k++) {
        if (valid[k]) {
            int p = neb[k][0] * W + neb[k][1];
            top_left[k] = (long long)(neb[k][0] - d->am_yoff[p]) * W
                          + (neb[k][1] - d->am_xoff[p]);
        } else top_left[k] = -1;
    }
    if (valid[2] && valid[1] && top_left[1] == top_left[2]) valid[2] = 0;
    if (valid[3] && valid[0] && top_left[0] == top_left[3]) valid[3] = 0;
    if ((valid[4] && valid[0] && top_left[4] == top_left[0])
        || (valid[4] && valid[1] && top_left[4] == top_left[1]))
        valid[4] = 0;
    for (int k = 0; k < 5; k++) {
        if (valid[k]) {
            int p = neb[k][0] * W + neb[k][1];
            cp_num[cnt] = d->am_aff[p] == 1 ? 2 : 3;
            for (int lidx = 0; lidx < 2; lidx++) {
                if (d->map_refi[p * 2 + lidx] >= 0) {
                    refi_l[cnt][lidx] = d->map_refi[p * 2 + lidx];
                    aff_model_mv(d, y_scu, x_scu, neb[k][0], neb[k][1],
                                 lidx, cuw, cuh, cp_num[cnt],
                                 log2_max_cuwh, cpmv[cnt][lidx]);
                } else {
                    refi_l[cnt][lidx] = REFI_INVALID;
                    memset(cpmv[cnt][lidx], 0, sizeof(cpmv[cnt][lidx]));
                }
            }
            cnt++;
        }
        if (cnt >= AFF_MODEL_CAND) break;
    }

    /* control-point based (constructed) */
    int cp_mv[2][VER_NUM][2];
    int cp_refi[2][VER_NUM];
    int cp_valid[VER_NUM] = {0, 0, 0, 0};
    memset(cp_mv, 0, sizeof(cp_mv));
    for (int l = 0; l < 2; l++)
        for (int i = 0; i < VER_NUM; i++) cp_refi[l][i] = REFI_INVALID;

#define PLAIN_OK(d, y, x) \
    (COD_OK(d, y, x) && !(d)->map_ibc[(y) * (d)->w_scu + (x)])

    {   /* LT */
        int cand[3][2] = {{y_scu - 1, x_scu - 1}, {y_scu - 1, x_scu},
                          {y_scu, x_scu - 1}};
        int cv[3] = {x_scu > 0 && y_scu > 0 && PLAIN_OK(d, cand[0][0], cand[0][1]),
                     y_scu > 0 && PLAIN_OK(d, cand[1][0], cand[1][1]),
                     x_scu > 0 && PLAIN_OK(d, cand[2][0], cand[2][1])};
        for (int k = 0; k < 3; k++) {
            if (cv[k]) {
                int p = cand[k][0] * W + cand[k][1];
                for (int l = 0; l < 2; l++) {
                    cp_refi[l][0] = d->map_refi[p * 2 + l];
                    cp_mv[l][0][0] = d->map_mv[(p * 2 + l) * 2];
                    cp_mv[l][0][1] = d->map_mv[(p * 2 + l) * 2 + 1];
                }
                cp_valid[0] = 1;
                break;
            }
        }
    }
    {   /* RT */
        int cand[3][2] = {{y_scu - 1, x_scu + scuw},
                          {y_scu - 1, x_scu + scuw - 1},
                          {y_scu, x_scu + scuw}};
        int cv[3] = {y_scu > 0 && x_scu + scuw < W
                     && PLAIN_OK(d, cand[0][0], cand[0][1]),
                     y_scu > 0 && PLAIN_OK(d, cand[1][0], cand[1][1]),
                     x_scu + scuw < W && PLAIN_OK(d, cand[2][0], cand[2][1])};
        for (int k = 0; k < 3; k++) {
            if (cv[k]) {
                int p = cand[k][0] * W + cand[k][1];
                for (int l = 0; l < 2; l++) {
                    cp_refi[l][1] = d->map_refi[p * 2 + l];
                    cp_mv[l][1][0] = d->map_mv[(p * 2 + l) * 2];
                    cp_mv[l][1][1] = d->map_mv[(p * 2 + l) * 2 + 1];
                }
                cp_valid[1] = 1;
                break;
            }
        }
    }
    /* LB */
    if (avail_lr == LR_10 || avail_lr == LR_11) {
        int cand[2][2] = {{y_scu + scuh, x_scu - 1},
                          {y_scu + scuh - 1, x_scu - 1}};
        int cv[2] = {x_scu > 0 && y_scu + scuh < H
                     && PLAIN_OK(d, cand[0][0], cand[0][1]),
                     x_scu > 0 && PLAIN_OK(d, cand[1][0], cand[1][1])};
        for (int k = 0; k < 2; k++) {
            if (cv[k]) {
                int p = cand[k][0] * W + cand[k][1];
                for (int l = 0; l < 2; l++) {
                    cp_refi[l][2] = d->map_refi[p * 2 + l];
                    cp_mv[l][2][0] = d->map_mv[(p * 2 + l) * 2];
                    cp_mv[l][2][1] = d->map_mv[(p * 2 + l) * 2 + 1];
                }
                cp_valid[2] = 1;
                break;
            }
        }
    } else {
        int same_row = (((y_scu + scuh) << 2) >> log2_max_cuwh)
                       == ((y_scu << 2) >> log2_max_cuwh);
        if (x_scu > 0 && y_scu + scuh < H && same_row) {
            int py = ((y_scu + scuh) >> 1) << 1;
            int px = ((x_scu - 1) >> 1) << 1;
            int tmvp[2][2];
            int avail = get_mv_collocated(d, py, px, y_scu, x_scu, tmvp);
            if (avail == 1 || avail == 3) {
                cp_refi[0][2] = 0;
                cp_mv[0][2][0] = tmvp[0][0];
                cp_mv[0][2][1] = tmvp[0][1];
            } else {
                cp_refi[0][2] = REFI_INVALID;
                cp_mv[0][2][0] = cp_mv[0][2][1] = 0;
            }
            if ((avail == 2 || avail == 3) && d->slice_type == SLICE_B) {
                cp_refi[1][2] = 0;
                cp_mv[1][2][0] = tmvp[1][0];
                cp_mv[1][2][1] = tmvp[1][1];
            } else {
                cp_refi[1][2] = REFI_INVALID;
                cp_mv[1][2][0] = cp_mv[1][2][1] = 0;
            }
        }
        if (cp_refi[0][2] >= 0 || cp_refi[1][2] >= 0) cp_valid[2] = 1;
    }
    /* RB */
    if (avail_lr == LR_01 || avail_lr == LR_11) {
        int cand[2][2] = {{y_scu + scuh, x_scu + scuw},
                          {y_scu + scuh - 1, x_scu + scuw}};
        int cv[2] = {x_scu + scuw < W && y_scu + scuh < H
                     && PLAIN_OK(d, cand[0][0], cand[0][1]),
                     x_scu + scuw < W && PLAIN_OK(d, cand[1][0], cand[1][1])};
        for (int k = 0; k < 2; k++) {
            if (cv[k]) {
                int p = cand[k][0] * W + cand[k][1];
                for (int l = 0; l < 2; l++) {
                    cp_refi[l][3] = d->map_refi[p * 2 + l];
                    cp_mv[l][3][0] = d->map_mv[(p * 2 + l) * 2];
                    cp_mv[l][3][1] = d->map_mv[(p * 2 + l) * 2 + 1];
                }
                break;
            }
        }
    } else {
        int same_line = (((y_scu + scuh) << 2) >> log2_max_cuwh)
                        == ((y_scu << 2) >> log2_max_cuwh);
        if (x_scu + scuw < W && y_scu + scuh < H && same_line) {
            int py = ((y_scu + scuh) >> 1) << 1;
            int px = ((x_scu + scuw) >> 1) << 1;
            int tmvp[2][2];
            int avail = get_mv_collocated(d, py, px, y_scu, x_scu, tmvp);
            if (avail == 1 || avail == 3) {
                cp_refi[0][3] = 0;
                cp_mv[0][3][0] = tmvp[0][0];
                cp_mv[0][3][1] = tmvp[0][1];
            } else {
                cp_refi[0][3] = REFI_INVALID;
                cp_mv[0][3][0] = cp_mv[0][3][1] = 0;
            }
            if ((avail == 2 || avail == 3) && d->slice_type == SLICE_B) {
                cp_refi[1][3] = 0;
                cp_mv[1][3][0] = tmvp[1][0];
                cp_mv[1][3][1] = tmvp[1][1];
            } else {
                cp_refi[1][3] = REFI_INVALID;
                cp_mv[1][3][0] = cp_mv[1][3][1] = 0;
            }
        }
    }
    if (cp_refi[0][3] >= 0 || cp_refi[1][3] >= 0) cp_valid[3] = 1;

    {
        static const int const_model[6][3] = {
            {0, 1, 2}, {0, 1, 3}, {0, 2, 3}, {1, 2, 3}, {0, 1, 0},
            {0, 2, 0}};
        static const int cp_nums[6] = {3, 3, 3, 3, 2, 2};
        for (int m = 0; m < 6 && cnt < AFF_MAX_CAND; m++)
            cnt = aff_constructed(cuw, cuh, cp_valid, cp_mv, cp_refi,
                                  const_model[m], m, cp_nums[m], cpmv,
                                  refi_l, cnt, cp_num);
    }
    for (int k = cnt; k < AFF_MAX_CAND; k++) {
        cp_num[k] = 2;
        memset(cpmv[k], 0, sizeof(cpmv[k]));
        refi_l[k][0] = 0;
        refi_l[k][1] = d->slice_type == SLICE_B ? 0 : REFI_INVALID;
    }
}

/* affine AMVP (ref: xevdm_get_affine_motion_scaling) */
static void aff_amvp(DM *d, int x_scu, int y_scu, int lidx, int cur_refi,
                     int cuw, int cuh, int vertex_num, int log2_max_cuwh,
                     int mvp[AFF_MAX_NUM_MVP][3][2]) {
    int W = d->w_scu, H = d->h_scu;
    int scuw = cuw >> 2, scuh = cuh >> 2;
    memset(mvp, 0, sizeof(int) * AFF_MAX_NUM_MVP * 3 * 2);
    int cnt = 0;
    /* inherited: left {A0,A1}, above {B0,B1,B2}, right {C0,C1} */
    int grp_pos[3][3][2] = {
        {{y_scu + scuh, x_scu - 1}, {y_scu + scuh - 1, x_scu - 1}, {0, 0}},
        {{y_scu - 1, x_scu + scuw}, {y_scu - 1, x_scu + scuw - 1},
         {y_scu - 1, x_scu - 1}},
        {{y_scu + scuh, x_scu + scuw}, {y_scu + scuh - 1, x_scu + scuw},
         {0, 0}}};
    int grp_cond[3][3] = {
        {x_scu > 0 && y_scu + scuh < H, x_scu > 0, 0},
        {y_scu > 0 && x_scu + scuw < W, y_scu > 0, x_scu > 0 && y_scu > 0},
        {x_scu + scuw < W && y_scu + scuh < H, x_scu + scuw < W, 0}};
    int grp_n[3] = {2, 3, 2};
    for (int g = 0; g < 3; g++) {
        for (int k = 0; k < grp_n[g]; k++) {
            int py = grp_pos[g][k][0], px = grp_pos[g][k][1];
            if (grp_cond[g][k] && AFF_OK(d, py, px)
                && d->map_refi[(py * W + px) * 2 + lidx] == cur_refi) {
                aff_model_mv(d, y_scu, x_scu, py, px, lidx, cuw, cuh,
                             vertex_num, log2_max_cuwh, mvp[cnt]);
                cnt++;
                break;
            }
        }
        if (cnt >= AFF_MAX_NUM_MVP) return;
    }
    /* corner translation candidates */
    int have[4] = {0, 0, 0, 0};     /* lt, rt, lb, rb */
    int cmv[4][2];
    {
        int cand[4][3][2] = {
            {{y_scu - 1, x_scu - 1}, {y_scu - 1, x_scu}, {y_scu, x_scu - 1}},
            {{y_scu - 1, x_scu + scuw}, {y_scu - 1, x_scu + scuw - 1},
             {y_scu, x_scu + scuw}},
            {{y_scu + scuh, x_scu - 1}, {y_scu + scuh - 1, x_scu - 1},
             {0, 0}},
            {{y_scu + scuh, x_scu + scuw}, {y_scu + scuh - 1, x_scu + scuw},
             {0, 0}}};
        int cond[4][3] = {
            {x_scu > 0 && y_scu > 0, y_scu > 0, x_scu > 0},
            {y_scu > 0 && x_scu + scuw < W, y_scu > 0, x_scu + scuw < W},
            {x_scu > 0 && y_scu + scuh < H, x_scu > 0, 0},
            {x_scu + scuw < W && y_scu + scuh < H, x_scu + scuw < W, 0}};
        int nn[4] = {3, 3, 2, 2};
        for (int c = 0; c < 4; c++) {
            for (int k = 0; k < nn[c]; k++) {
                int py = cand[c][k][0], px = cand[c][k][1];
                if (cond[c][k] && PLAIN_OK(d, py, px)
                    && d->map_refi[(py * W + px) * 2 + lidx] >= 0) {
                    if (d->map_refi[(py * W + px) * 2 + lidx] == cur_refi) {
                        have[c] = 1;
                        cmv[c][0] = d->map_mv[((py * W + px) * 2
                                               + lidx) * 2];
                        cmv[c][1] = d->map_mv[((py * W + px) * 2
                                               + lidx) * 2 + 1];
                        break;
                    }
                }
            }
        }
    }
    if (have[0] && have[1] && (vertex_num == 2 || have[2] || have[3])) {
        mvp[cnt][0][0] = cmv[0][0]; mvp[cnt][0][1] = cmv[0][1];
        mvp[cnt][1][0] = cmv[1][0]; mvp[cnt][1][1] = cmv[1][1];
        if (have[2]) {
            mvp[cnt][2][0] = cmv[2][0]; mvp[cnt][2][1] = cmv[2][1];
        } else if (have[3]) {
            mvp[cnt][2][0] = s16c(cmv[3][0] + cmv[0][0] - cmv[1][0]);
            mvp[cnt][2][1] = s16c(cmv[3][1] + cmv[0][1] - cmv[1][1]);
        } else {
            mvp[cnt][2][0] = mvp[cnt][2][1] = 0;
        }
        cnt++;
    }
    if (cnt == AFF_MAX_NUM_MVP) return;
    if (have[2]) {
        for (int i = 0; i < 3; i++) {
            mvp[cnt][i][0] = cmv[2][0]; mvp[cnt][i][1] = cmv[2][1];
        }
        cnt++;
    } else if (have[3]) {
        for (int i = 0; i < 3; i++) {
            mvp[cnt][i][0] = cmv[3][0]; mvp[cnt][i][1] = cmv[3][1];
        }
        cnt++;
    }
    if (cnt == AFF_MAX_NUM_MVP) return;
    if (have[1]) {
        for (int i = 0; i < 3; i++) {
            mvp[cnt][i][0] = cmv[1][0]; mvp[cnt][i][1] = cmv[1][1];
        }
        cnt++;
    }
    if (cnt == AFF_MAX_NUM_MVP) return;
    if (have[0]) {
        for (int i = 0; i < 3; i++) {
            mvp[cnt][i][0] = cmv[0][0]; mvp[cnt][i][1] = cmv[0][1];
        }
        cnt++;
    }
    /* remaining slots stay zero */
}

/* EIF applicability / sub-block size (ref: xevdm_util.c:1870-2149) */
#define AFFINE_ADAPT_EIF_SIZE 8
#define EIF_SUBBLOCK_SIZE 4
#define EIF_FETCH_LINES 3
#define MAX_MEMORY_ACCESS_BI 72
#define AFF_MAX_CU_LOG2 7

static int aff_eif_uni(const int ac_mv[VER_NUM][2], int cuw, int cuh,
                       int vertex_num, int *mem_band_ok) {
    int prec_add = AFF_MAX_CU_LOG2;
    int mv_precision = 2 + prec_add;
    int d_hor[2], d_ver[2];
    aff_model_params(ac_mv, cuw, cuh, vertex_num, prec_add, d_hor, d_ver);
    /* bounding box at EIF_SUBBLOCK_SIZE */
    long long cx[4], cy[4];
    int w = EIF_SUBBLOCK_SIZE, h = EIF_SUBBLOCK_SIZE;
    cx[0] = 0;
    cx[1] = (long long)(w + 1) * (d_hor[0] + (1 << mv_precision));
    cx[2] = (long long)(h + 1) * d_ver[0];
    cx[3] = cx[1] + cx[2] - cx[0];
    cy[0] = 0;
    cy[1] = (long long)(w + 1) * d_hor[1];
    cy[2] = (long long)(h + 1) * (d_ver[1] + (1 << mv_precision));
    cy[3] = cy[1] + cy[2] - cy[0];
    long long mxx = cx[0], mnx = cx[0], mxy = cy[0], mny = cy[0];
    for (int i = 1; i < 4; i++) {
        if (cx[i] > mxx) mxx = cx[i];
        if (cx[i] < mnx) mnx = cx[i];
        if (cy[i] > mxy) mxy = cy[i];
        if (cy[i] < mny) mny = cy[i];
    }
    long long bw = ((mxx - mnx + (1 << mv_precision) - 1) >> mv_precision)
                   + 2;
    long long bh = ((mxy - mny + (1 << mv_precision) - 1) >> mv_precision)
                   + 2;
    *mem_band_ok = bw * bh <= MAX_MEMORY_ACCESS_BI;
    if (d_ver[1] < -(1 << mv_precision)) return 0;
    long long lhs = (long long)((d_ver[1] > 0 ? d_ver[1] : 0)
                                + (d_hor[1] < 0 ? -d_hor[1] : d_hor[1]))
                    * (1 + EIF_SUBBLOCK_SIZE);
    if (lhs > (long long)(EIF_FETCH_LINES - 2) << mv_precision) return 0;
    return 1;
}

static void aff_subblock_wh(const int ac_mv[VER_NUM][2], int cuw, int cuh,
                            int vertex_num, int *ow, int *oh) {
    int d_hor[2], d_ver[2];
    aff_model_params(ac_mv, cuw, cuh, vertex_num, 7, d_hor, d_ver);
    int wx = d_hor[0] < 0 ? -d_hor[0] : d_hor[0];
    int t = d_hor[1] < 0 ? -d_hor[1] : d_hor[1];
    if (t > wx) wx = t;
    int wy = d_ver[0] < 0 ? -d_ver[0] : d_ver[0];
    t = d_ver[1] < 0 ? -d_ver[1] : d_ver[1];
    if (t > wy) wy = t;
    static const int sub_lut[4] = {32, 16, 8, 8};
    *ow = wx > 4 ? 4 : (wx == 0 ? cuw : sub_lut[wx - 1]);
    *oh = wy > 4 ? 4 : (wy == 0 ? cuh : sub_lut[wy - 1]);
}

static void aff_subblock_bi(const int ac_mv2[2][VER_NUM][2],
                            const int refi[2], int cuw, int cuh,
                            int vertex_num, int *ow, int *oh,
                            int *mem_band_ok) {
    int sw = cuw, sh = cuh;
    for (int l = 0; l < 2; l++) {
        if (refi[l] >= 0) {
            int w, h;
            aff_subblock_wh(ac_mv2[l], cuw, cuh, vertex_num, &w, &h);
            if (w < sw) sw = w;
            if (h < sh) sh = h;
        }
    }
    int mb = 1, ok = 1;
    for (int l = 0; l < 2; l++) {
        if (refi[l] >= 0) {
            int mbl;
            int okl = aff_eif_uni(ac_mv2[l], cuw, cuh, vertex_num, &mbl);
            mb = mb && mbl;
            if (!okl) { ok = 0; break; }
        }
    }
    if (!ok) {
        if (sw < AFFINE_ADAPT_EIF_SIZE) sw = AFFINE_ADAPT_EIF_SIZE;
        if (sh < AFFINE_ADAPT_EIF_SIZE) sh = AFFINE_ADAPT_EIF_SIZE;
    }
    *ow = sw;
    *oh = sh;
    *mem_band_ok = mb;
}

/* sub-block motion field write-back (ref: xevdm_set_affine_mvf) */
static void aff_set_mvf(DM *d, int x_scu, int y_scu, int log2w, int log2h,
                        const int refi[2], const int ac_mv2[2][VER_NUM][2],
                        int vertex_num) {
    int W = d->w_scu;
    int w_cu = (1 << log2w) >> 2, h_cu = (1 << log2h) >> 2;
    int sub_w, sub_h, mb;
    aff_subblock_bi(ac_mv2, refi, 1 << log2w, 1 << log2h, vertex_num,
                    &sub_w, &sub_h, &mb);
    int sws = sub_w >> 2, shs = sub_h >> 2;
    int half_w = sub_w >> 1, half_h = sub_h >> 1;
    for (int lidx = 0; lidx < 2; lidx++) {
        if (refi[lidx] < 0) continue;
        const int (*ac_mv)[2] = ac_mv2[lidx];
        int dhx = (ac_mv[1][0] - ac_mv[0][0]) << (7 - log2w);
        int dhy = (ac_mv[1][1] - ac_mv[0][1]) << (7 - log2w);
        int dvx, dvy;
        if (vertex_num == 3) {
            dvx = (ac_mv[2][0] - ac_mv[0][0]) << (7 - log2h);
            dvy = (ac_mv[2][1] - ac_mv[0][1]) << (7 - log2h);
        } else {
            dvx = -dhy;
            dvy = dhx;
        }
        long long msh = (long long)ac_mv[0][0] << 7;
        long long msv = (long long)ac_mv[0][1] << 7;
        for (int h = 0; h < h_cu; h += shs) {
            for (int w = 0; w < w_cu; w += sws) {
                int th, tv;
                if (w == 0 && h == 0) {
                    th = ac_mv[0][0]; tv = ac_mv[0][1];
                } else if (w + sws == w_cu && h == 0) {
                    th = ac_mv[1][0]; tv = ac_mv[1][1];
                } else if (w == 0 && h + shs == h_cu && vertex_num == 3) {
                    th = ac_mv[2][0]; tv = ac_mv[2][1];
                } else {
                    int pos_x = (w << 2) + half_w;
                    int pos_y = (h << 2) + half_h;
                    long long hh = msh + (long long)dhx * pos_x
                                   + (long long)dvx * pos_y;
                    long long vv = msv + (long long)dhy * pos_x
                                   + (long long)dvy * pos_y;
                    aff_mv_rounding(hh, vv, 5, &th, &tv);
                    if (th < -(1 << 17)) th = -(1 << 17);
                    if (th > (1 << 17) - 1) th = (1 << 17) - 1;
                    if (tv < -(1 << 17)) tv = -(1 << 17);
                    if (tv > (1 << 17) - 1) tv = (1 << 17) - 1;
                    th >>= 2;
                    tv >>= 2;
                }
                for (int yy = h; yy < h + shs; yy++)
                    for (int xx = w; xx < w + sws; xx++) {
                        int p = (y_scu + yy) * W + x_scu + xx;
                        d->map_mv[(p * 2 + lidx) * 2] = (int16_t)th;
                        d->map_mv[(p * 2 + lidx) * 2 + 1] = (int16_t)tv;
                    }
            }
        }
    }
    for (int yy = 0; yy < h_cu; yy++)
        for (int xx = 0; xx < w_cu; xx++) {
            int p = (y_scu + yy) * W + x_scu + xx;
            d->map_refi[p * 2] = (int8_t)refi[0];
            d->map_refi[p * 2 + 1] = (int8_t)refi[1];
        }
}

/* HMVP center MV (ref: src_main/xevdm.c:657-800) */
static int aff_center_mv(const int ac_mv2[2][VER_NUM][2],
                         const int refi[2], int log2w, int log2h,
                         int vertex_num, int refi_sp[2], int mv_sp[2][2]) {
    refi_sp[0] = refi_sp[1] = REFI_INVALID;
    mv_sp[0][0] = mv_sp[0][1] = mv_sp[1][0] = mv_sp[1][1] = 0;
    for (int lidx = 0; lidx < 2; lidx++) {
        if (refi[lidx] < 0) continue;
        const int (*ac_mv)[2] = ac_mv2[lidx];
        int dhx = (ac_mv[1][0] - ac_mv[0][0]) << (7 - log2w);
        int dhy = (ac_mv[1][1] - ac_mv[0][1]) << (7 - log2w);
        int dvx, dvy;
        if (vertex_num == 3) {
            dvx = (ac_mv[2][0] - ac_mv[0][0]) << (7 - log2h);
            dvy = (ac_mv[2][1] - ac_mv[0][1]) << (7 - log2h);
        } else {
            dvx = -dhy;
            dvy = dhx;
        }
        int pos_x = 1 << (log2w - 1), pos_y = 1 << (log2h - 1);
        long long th = ((long long)ac_mv[0][0] << 7)
                       + (long long)dhx * pos_x + (long long)dvx * pos_y;
        long long tv = ((long long)ac_mv[0][1] << 7)
                       + (long long)dhy * pos_x + (long long)dvy * pos_y;
        int h, v;
        aff_mv_rounding(th, tv, 7, &h, &v);
        if (h < -(1 << 15)) h = -(1 << 15);
        if (h > (1 << 15) - 1) h = (1 << 15) - 1;
        if (v < -(1 << 15)) v = -(1 << 15);
        if (v > (1 << 15) - 1) v = (1 << 15) - 1;
        mv_sp[lidx][0] = h;
        mv_sp[lidx][1] = v;
        refi_sp[lidx] = refi[lidx];
    }
    return refi_sp[0] >= 0 || refi_sp[1] >= 0;
}

/* full Main derive pass; returns 0 */
int evc_main_derive(
    const int32_t *params, int n_cus, const int32_t *cu,
    const uint8_t *map_if,
    const int32_t *refp_poc_flat,            /* [2][MAX_REFP] */
    const int8_t *col_map_refi, const int16_t *col_map_mv,
    int col_poc, const int32_t *col_list_poc,
    const int16_t *r00_mv, const int16_t *r01_mv,
    /* outputs */
    int32_t *cu_mv, int32_t *cu_refi,
    int16_t *map_mv, int8_t *map_refi,
    int64_t *nbr_up, int64_t *nbr_left, uint8_t *nbr_corner,
    int64_t *nbr_upext, int64_t *nbr_right, uint8_t *avail_lr_out,
    int32_t *htdf_idx, int32_t *htdf_avail,
    int32_t *cu_aff_flag, int32_t *cu_aff_mv)
{
    DM d;
    memset(&d, 0, sizeof(d));
    d.p = params;
    int w = params[D_W], h = params[D_H];
    d.w_scu = (w + 3) >> 2;
    d.h_scu = (h + 3) >> 2;
    d.slice_type = params[D_SLICE_TYPE];
    d.poc = params[D_POC];
    d.map_if = map_if;
    d.map_mv = map_mv;
    d.map_refi = map_refi;
    for (int l = 0; l < 2; l++)
        for (int i = 0; i < MAX_REFP; i++)
            d.refp_poc[l][i] = refp_poc_flat[l * MAX_REFP + i];
    d.col_refi = col_map_refi;
    d.col_mv = col_map_mv;
    d.col_poc = col_poc;
    d.col_list_poc = col_list_poc;
    d.r00_mv = r00_mv;
    d.r01_mv = r01_mv;
    d.r1_poc = params[D_R1_POC];
    d.r1_list_poc0 = params[D_R1_LIST_POC0];

    int W = d.w_scu, H = d.h_scu;
    size_t n_scu = (size_t)W * H;
    d.cod = (uint8_t *)calloc(n_scu, 1);
    if (!d.cod) return -1;
    d.am_aff = (uint8_t *)calloc(n_scu, 4);
    d.am_xoff = (uint16_t *)calloc(n_scu, 2 * sizeof(uint16_t));
    if (!d.am_aff || !d.am_xoff) {
        free(d.cod); free(d.am_aff); free(d.am_xoff);
        return -1;
    }
    d.am_logw = d.am_aff + n_scu;
    d.am_logh = d.am_aff + 2 * n_scu;
    d.map_ibc = d.am_aff + 3 * n_scu;
    d.am_yoff = d.am_xoff + n_scu;
    memset(map_mv, 0, n_scu * 4 * sizeof(int16_t));
    memset(map_refi, -1, n_scu * 2);

    int use_admvp = params[D_ADMVP];
    int hmvp = params[D_HMVP];
    int htdf_on = params[D_HTDF];
    int constrained = params[D_CONSTRAINED];
    int log2_ctu = params[D_LOG2_CTU];
    int cur_ctu_row = -1;

    for (int i = 0; i < n_cus; i++) {
        const int32_t *r = cu + (int64_t)i * MAIN_CU_FIELDS;
        int x = r[M_X], y = r[M_Y];
        int cuw = 1 << r[M_LOG2W], cuh = 1 << r[M_LOG2H];
        if (hmvp) {
            int row = y >> log2_ctu;
            if (row != cur_ctu_row) { cur_ctu_row = row; d.hist_n = 0; }
        }
        int x_scu = x >> 2, y_scu = y >> 2;
        int scuw = cuw >> 2, scuh = cuh >> 2;
        int pm = r[M_PRED_MODE];

        nbr_up[i] = nbr_left[i] = nbr_upext[i] = nbr_right[i] = 0;
        nbr_corner[i] = 0;
        avail_lr_out[i] = 0;
        cu_mv[i * 4] = cu_mv[i * 4 + 1] = cu_mv[i * 4 + 2] =
            cu_mv[i * 4 + 3] = 0;
        cu_refi[i * 2] = cu_refi[i * 2 + 1] = REFI_INVALID;
        cu_aff_flag[i] = 0;
        memset(cu_aff_mv + i * 12, 0, 12 * sizeof(int32_t));
        int aff_parsed = r[M_AFF_FLAG];

        if (pm == MODE_INTRA) {
            /* (ref: src_base/xevd_ipred.c:33-93, xevd_util.c:689-745,
               src_main/xevdm_ipred.c:78-145) */
            int n_units = scuw + scuh;
            uint64_t up_mask = 0, left_mask = 0, upext = 0, right = 0;
            if (y_scu > 0)
                for (int u = 0; u < n_units; u++) {
                    int xs = x_scu + u;
                    if (xs < W && d.cod[(y_scu - 1) * W + xs]
                        && (!constrained || map_if[(y_scu - 1) * W + xs]))
                        up_mask |= 1ull << u;
                }
            if (x_scu > 0)
                for (int u = 0; u < n_units; u++) {
                    int ys = y_scu + u;
                    if (ys < H && d.cod[ys * W + x_scu - 1]
                        && (!constrained || map_if[ys * W + x_scu - 1]))
                        left_mask |= 1ull << u;
                }
            int corner = 0;
            if (x_scu > 0 && y_scu > 0 && d.cod[(y_scu - 1) * W + x_scu - 1]
                && (!constrained || map_if[(y_scu - 1) * W + x_scu - 1]))
                corner = 1;
            if (y_scu > 0 && x_scu > 0)
                for (int u = 0; u < scuh; u++) {
                    int xs = x_scu - 1 - u;
                    if (xs >= 0 && d.cod[(y_scu - 1) * W + xs]
                        && (!constrained || map_if[(y_scu - 1) * W + xs]))
                        upext |= 1ull << u;
                }
            if (x_scu + scuw < W)
                for (int u = 0; u < n_units; u++) {
                    int ys = y_scu + u;
                    if (ys < H && d.cod[ys * W + x_scu + scuw]
                        && (!constrained || map_if[ys * W + x_scu + scuw]))
                        right |= 1ull << u;
                }
            int lr = 0;
            if (x_scu > 0 && d.cod[y_scu * W + x_scu - 1]) lr += 1;
            if (x_scu + scuw < W && d.cod[y_scu * W + x_scu + scuw]) lr += 2;
            nbr_up[i] = (int64_t)up_mask;
            nbr_left[i] = (int64_t)left_mask;
            nbr_corner[i] = (uint8_t)corner;
            nbr_upext[i] = (int64_t)upext;
            nbr_right[i] = (int64_t)right;
            avail_lr_out[i] = (uint8_t)lr;
            for (int j = 0; j < scuh; j++) {
                int rowp = (y_scu + j) * W + x_scu;
                for (int ii = 0; ii < scuw; ii++) {
                    map_refi[(rowp + ii) * 2] = REFI_INVALID;
                    map_refi[(rowp + ii) * 2 + 1] = REFI_INVALID;
                    int16_t *mm = map_mv + (rowp + ii) * 4;
                    mm[0] = mm[1] = mm[2] = mm[3] = 0;
                }
            }
        } else {
            int refi[2] = {REFI_INVALID, REFI_INVALID};
            int mv[2][2] = {{0, 0}, {0, 0}};
            int inter_dir = r[M_INTER_DIR];
            int refi_parsed[2] = {r[M_REFI0], r[M_REFI1]};
            int mvp_idx[2] = {r[M_MVP0], r[M_MVP1]};

            int aff_vertex = 0;
            int ac_mv2[2][VER_NUM][2];
            memset(ac_mv2, 0, sizeof(ac_mv2));
            if (pm == MODE_IBC) {
                /* block vector = raw mvd (ref: xevdm_eco.c:1789-1800) */
                mv[0][0] = r[M_MVD0X];
                mv[0][1] = r[M_MVD0Y];
                refi[0] = refi[1] = REFI_INVALID;
                for (int j = 0; j < scuh; j++)
                    memset(d.map_ibc + (y_scu + j) * W + x_scu, 1, scuw);
            } else if (aff_parsed && (pm == MODE_SKIP || pm == MODE_DIR)) {
                /* affine merge (ref: src_main/xevdm.c:946-977) */
                int lr = dm_avail_lr(&d, x_scu, y_scu, scuw);
                int refi_l[AFF_MAX_CAND][2];
                int cpmv[AFF_MAX_CAND][2][3][2];
                int cp_num[AFF_MAX_CAND];
                aff_merge_candidates(&d, x_scu, y_scu, cuw, cuh, lr,
                                     log2_ctu, refi_l, cpmv, cp_num);
                int mrg = mvp_idx[0];
                aff_vertex = cp_num[mrg];
                refi[0] = refi_l[mrg][0];
                refi[1] = refi_l[mrg][1];
                for (int l = 0; l < 2; l++) {
                    if (refi[l] >= 0)
                        for (int v = 0; v < 3; v++) {
                            ac_mv2[l][v][0] = cpmv[mrg][l][v][0];
                            ac_mv2[l][v][1] = cpmv[mrg][l][v][1];
                        }
                }
            } else if (aff_parsed && pm == MODE_INTER) {
                /* affine AMVP (ref: src_main/xevdm.c:978-1021) */
                aff_vertex = aff_parsed + 1;
                for (int lidx = 0; lidx < 2; lidx++) {
                    if (((inter_dir + 1) >> lidx) & 1) {
                        refi[lidx] = refi_parsed[lidx];
                        int mvp_a[AFF_MAX_NUM_MVP][3][2];
                        aff_amvp(&d, x_scu, y_scu, lidx, refi[lidx], cuw,
                                 cuh, aff_vertex, log2_ctu, mvp_a);
                        const int (*mp)[2] = mvp_a[mvp_idx[lidx]];
                        for (int v = 0; v < aff_vertex; v++) {
                            int m0x = v > 0 ? r[M_AFF_MVD + lidx * 6] : 0;
                            int m0y = v > 0 ? r[M_AFF_MVD + lidx * 6 + 1]
                                            : 0;
                            ac_mv2[lidx][v][0] = s16w(
                                mp[v][0] + m0x
                                + r[M_AFF_MVD + (lidx * 3 + v) * 2]);
                            ac_mv2[lidx][v][1] = s16w(
                                mp[v][1] + m0y
                                + r[M_AFF_MVD + (lidx * 3 + v) * 2 + 1]);
                        }
                    }
                }
            } else if (use_admvp && (pm == MODE_SKIP || pm == MODE_DIR)) {
                int lr = dm_avail_lr(&d, x_scu, y_scu, scuw);
                if (r[M_MMVD_FLAG]) {
                    get_mmvd_motion(&d, r[M_MMVD_IDX], x_scu, y_scu, cuw,
                                    cuh, lr, refi, mv);
                    if (d.slice_type == SLICE_P) {
                        refi[1] = REFI_INVALID;
                        mv[1][0] = mv[1][1] = 0;
                    }
                } else {
                    MergeList ml;
                    get_motion_merge_main(&d, x_scu, y_scu, cuw, cuh, lr,
                                          &ml);
                    int idx0 = mvp_idx[0];
                    refi[0] = ml.refi[0][idx0];
                    refi[1] = ml.refi[1][idx0];
                    mv[0][0] = ml.mvp[0][idx0][0];
                    mv[0][1] = ml.mvp[0][idx0][1];
                    mv[1][0] = ml.mvp[1][idx0][0];
                    mv[1][1] = ml.mvp[1][idx0][1];
                    if (d.slice_type == SLICE_P) {
                        refi[1] = REFI_INVALID;
                        mv[1][0] = mv[1][1] = 0;
                    }
                }
            } else if (use_admvp) {
                int lr = dm_avail_lr(&d, x_scu, y_scu, scuw);
                int mvr = r[M_MVR_IDX];
                int bi = r[M_BI_IDX];
                for (int lidx = 0; lidx < 2; lidx++) {
                    if (((inter_dir + 1) >> lidx) & 1) {
                        if (bi == 2 || bi == 3)
                            refi[lidx] = get_first_refi(
                                &d, x_scu, y_scu, cuw, cuh, lidx, mvr, lr,
                                hmvp);
                        else
                            refi[lidx] = refi_parsed[lidx];
                        int nrefp = lidx == 0 ? params[D_NUM_REFP0]
                                              : params[D_NUM_REFP1];
                        int mvp0[2];
                        get_motion_from_mvr(&d, mvr, x_scu, y_scu, lidx,
                                            refi[lidx], nrefp, cuw, cuh,
                                            lr, hmvp, mvp0);
                        int mvdx = r[M_MVD0X + lidx * 2];
                        int mvdy = r[M_MVD0Y + lidx * 2];
                        if (bi == 2 + lidx) { mvdx = 0; mvdy = 0; }
                        mv[lidx][0] = s16w(mvp0[0] + (mvdx << mvr));
                        mv[lidx][1] = s16w(mvp0[1] + (mvdy << mvr));
                    }
                }
            } else if (pm == MODE_SKIP) {
                /* baseline skip (ref: src_base/xevd.c:507-538) */
                int avail = 0;
                if (x_scu > 0 && !map_if[y_scu * W + x_scu - 1]
                    && d.cod[y_scu * W + x_scu - 1])
                    avail |= 2;
                if (y_scu > 0) {
                    if (!map_if[(y_scu - 1) * W + x_scu]) avail |= 1;
                    if (x_scu + scuw < W
                        && d.cod[(y_scu - 1) * W + x_scu + scuw]
                        && !map_if[(y_scu - 1) * W + x_scu + scuw])
                        avail |= 4;
                }
                int nl = d.slice_type == SLICE_B ? 2 : 1;
                for (int lidx = 0; lidx < nl; lidx++) {
                    int mvp[4][2];
                    mvp_candidates_b(&d, lidx, x_scu, y_scu, scuw, avail,
                                     mvp);
                    mv[lidx][0] = mvp[mvp_idx[lidx]][0];
                    mv[lidx][1] = mvp[mvp_idx[lidx]][1];
                    refi[lidx] = 0;
                }
                if (d.slice_type == SLICE_P) {
                    refi[1] = REFI_INVALID;
                    mv[1][0] = mv[1][1] = 0;
                }
            } else if (inter_dir == PRED_DIR) {
                /* temporal direct (ref: src_base/xevd_util.c:540-566) */
                int yc = y_scu + scuh - 1, xc = x_scu + scuw - 1;
                const int16_t *p = d.r01_mv
                    + ((yc * W + xc) * 2 + 0) * 2;
                int dpoc_co = d.r1_poc - d.r1_list_poc0;
                int dpoc_l0 = d.poc - d.refp_poc[0][0];
                int dpoc_l1 = d.r1_poc - d.poc;
                if (dpoc_co == 0) {
                    mv[0][0] = mv[0][1] = mv[1][0] = mv[1][1] = 0;
                } else {
                    mv[0][0] = (int)c_div((long long)dpoc_l0 * p[0], dpoc_co);
                    mv[0][1] = (int)c_div((long long)dpoc_l0 * p[1], dpoc_co);
                    mv[1][0] = (int)c_div(-(long long)dpoc_l1 * p[0],
                                          dpoc_co);
                    mv[1][1] = (int)c_div(-(long long)dpoc_l1 * p[1],
                                          dpoc_co);
                }
                refi[0] = refi[1] = 0;
            } else {
                int avail = 0;
                if (x_scu > 0 && !map_if[y_scu * W + x_scu - 1]
                    && d.cod[y_scu * W + x_scu - 1])
                    avail |= 2;
                if (y_scu > 0) {
                    if (!map_if[(y_scu - 1) * W + x_scu]) avail |= 1;
                    if (x_scu + scuw < W
                        && d.cod[(y_scu - 1) * W + x_scu + scuw]
                        && !map_if[(y_scu - 1) * W + x_scu + scuw])
                        avail |= 4;
                }
                for (int lidx = 0; lidx < 2; lidx++) {
                    if (((inter_dir + 1) >> lidx) & 1) {
                        int mvp[4][2];
                        mvp_candidates_b(&d, lidx, x_scu, y_scu, scuw,
                                         avail, mvp);
                        mv[lidx][0] = s16w(mvp[mvp_idx[lidx]][0]
                                           + r[M_MVD0X + lidx * 2]);
                        mv[lidx][1] = s16w(mvp[mvp_idx[lidx]][1]
                                           + r[M_MVD0Y + lidx * 2]);
                        refi[lidx] = refi_parsed[lidx];
                    }
                }
            }

            if (aff_vertex) {
                aff_set_mvf(&d, x_scu, y_scu, r[M_LOG2W], r[M_LOG2H],
                            refi, (const int (*)[VER_NUM][2])ac_mv2,
                            aff_vertex);
                if (hmvp) {
                    int refi_sp[2], mv_sp[2][2];
                    int any = aff_center_mv(
                        (const int (*)[VER_NUM][2])ac_mv2, refi,
                        r[M_LOG2W], r[M_LOG2H], aff_vertex, refi_sp,
                        mv_sp);
                    hist_update_v(&d, refi_sp,
                                  (const int (*)[2])mv_sp, any);
                }
                cu_aff_flag[i] = aff_vertex - 1;
                for (int l = 0; l < 2; l++)
                    for (int v = 0; v < 3; v++) {
                        cu_aff_mv[i * 12 + (l * 3 + v) * 2] =
                            ac_mv2[l][v][0];
                        cu_aff_mv[i * 12 + (l * 3 + v) * 2 + 1] =
                            ac_mv2[l][v][1];
                    }
                cu_refi[i * 2] = refi[0];
                cu_refi[i * 2 + 1] = refi[1];
            } else {
            if (hmvp && pm != MODE_IBC)
                hist_update(&d, refi, (const int (*)[2])mv);

            cu_mv[i * 4] = mv[0][0];
            cu_mv[i * 4 + 1] = mv[0][1];
            cu_mv[i * 4 + 2] = mv[1][0];
            cu_mv[i * 4 + 3] = mv[1][1];
            cu_refi[i * 2] = refi[0];
            cu_refi[i * 2 + 1] = refi[1];
            for (int j = 0; j < scuh; j++) {
                int rowp = (y_scu + j) * W + x_scu;
                for (int ii = 0; ii < scuw; ii++) {
                    map_refi[(rowp + ii) * 2] = (int8_t)refi[0];
                    map_refi[(rowp + ii) * 2 + 1] = (int8_t)refi[1];
                    int16_t *mm = map_mv + (rowp + ii) * 4;
                    mm[0] = (int16_t)mv[0][0];
                    mm[1] = (int16_t)mv[0][1];
                    mm[2] = (int16_t)mv[1][0];
                    mm[3] = (int16_t)mv[1][1];
                }
            }
            }
            /* affine-geometry maps: set for affine CUs, cleared otherwise */
            for (int j = 0; j < scuh; j++)
                for (int ii = 0; ii < scuw; ii++) {
                    int p = (y_scu + j) * W + x_scu + ii;
                    d.am_aff[p] = (uint8_t)(aff_vertex ? aff_vertex - 1
                                                       : 0);
                    if (aff_vertex) {
                        d.am_logw[p] = (uint8_t)r[M_LOG2W];
                        d.am_logh[p] = (uint8_t)r[M_LOG2H];
                        d.am_xoff[p] = (uint16_t)ii;
                        d.am_yoff[p] = (uint16_t)j;
                    }
                }
        }

        htdf_idx[i] = -1;
        htdf_avail[i] = 0;
        if (htdf_on && r[M_TREE] != 2 && pm != MODE_IBC
            && (pm == MODE_INTRA || r[M_CBF_Y])) {
            int idx = htdf_skip_and_idx(cuw, cuh, pm == MODE_INTRA,
                                        params[D_SH_QP]);
            if (idx >= 0) {
                htdf_idx[i] = idx;
                int av = 0;
                if (x_scu > 0 && d.cod[y_scu * W + x_scu - 1]) {
                    av |= HT_LE;
                    if (y_scu + scuh + scuw - 1 < H
                        && d.cod[(y_scu + scuw + scuh - 1) * W + x_scu - 1])
                        av |= HT_LO_LE;
                }
                if (y_scu > 0) {
                    av |= HT_UP;
                    if (x_scu > 0 && d.cod[(y_scu - 1) * W + x_scu - 1])
                        av |= HT_UP_LE;
                    if (x_scu + scuw < W
                        && d.cod[(y_scu - 1) * W + x_scu + scuw])
                        av |= HT_UP_RI;
                }
                if (x_scu + scuw < W && d.cod[y_scu * W + x_scu + scuw]) {
                    av |= HT_RI;
                    if (y_scu + scuh + scuw - 1 < H
                        && d.cod[(y_scu + scuw + scuh - 1) * W
                                 + x_scu + scuw])
                        av |= HT_LO_RI;
                }
                htdf_avail[i] = av;
            }
        }

        for (int j = 0; j < scuh; j++)
            memset(d.cod + (y_scu + j) * W + x_scu, 1, scuw);
    }
    free(d.cod);
    free(d.am_aff);
    free(d.am_xoff);
    return 0;
}

