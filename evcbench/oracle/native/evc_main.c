/* Native host entropy engine for xevd_tpu: EVC Main-profile slice decode.
 *
 * Mirrors the Python Main entropy pass (xevd_tpu/frame.py) bit-for-bit:
 * BTT/SUCO tree (ref: src_main/xevdm.c:1640-1850, xevdm_eco.c:1173-1334),
 * CM_INIT context seeding (ref: src_base/xevd_util.c:1243-1275),
 * Main CU syntax incl. MMVD/AMVR/ATS (ref: src_main/xevdm_eco.c:1467-1819),
 * EIPD intra-mode MPM derivation (ref: src_main/xevdm_ipred.c:320-769),
 * ADCC coefficient decode (ref: src_main/xevdm_eco.c:395-696) and the
 * run/level fallback with CM_INIT contexts (:303-352), ALF CTU flags
 * (ref: src_main/xevdm.c:2411-2427).  Emits the flat per-frame tensor
 * batch consumed by derive.py + the pixel backends.  Pure C99, ctypes.
 */
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#ifdef EVC_MAIN_TRACE
#include <stdio.h>
#endif
#include "evc_main_tables.h"

#define PROB_INIT 512
#define SLICE_B 0
#define SLICE_P 1
#define SLICE_I 2
#define MODE_INTRA 0
#define MODE_INTER 1
#define MODE_SKIP 2
#define MODE_DIR 3
#define MODE_IBC 6
#define PRED_L0 0
#define PRED_L1 1
#define PRED_BI 2
#define PRED_DIR 4
#define REFI_INVALID (-1)
#define MAX_TR_LOG2 6

/* split modes / trees / mode-cons (partition.py) */
#define NO_SPLIT 0
#define SPLIT_BI_VER 1
#define SPLIT_BI_HOR 2
#define SPLIT_TRI_VER 3
#define SPLIT_TRI_HOR 4
#define SPLIT_QUAD 5
#define TREE_LC 0
#define TREE_L 1
#define TREE_C 2
#define MC_ALL 0
#define MC_ONLY_INTRA 1
#define MC_ONLY_INTER 2

/* EIPD mode constants (tables.py:51-65) */
#define IPD_DC 0
#define IPD_PLN 1
#define IPD_BI 2
#define IPD_VER 12
#define IPD_HOR 24
#define IPD_DIA_R 18
#define IPD_DIA_L 6
#define IPD_DIA_U 30
#define IPD_CNT 33
#define IPD_BI_C 1
#define IPD_DC_C 2
#define IPD_HOR_C 3
#define IPD_VER_C 4
#define IPD_CHROMA_CNT 5
#define IPD_CNT_B 5

/* ADCC (tables.py:363-377) */
#define LOG2_CG_SIZE 4
#define CAFLAG_NUMBER 8
#define NUM_CTX_LAST_SIG_COEFF_LUMA 18
#define NUM_CTX_SIG_COEFF_LUMA 39
#define NUM_CTX_SIG_COEFF_LUMA_TU 13
#define NUM_CTX_GTX_LUMA 13

/* model counts needed for ctx clipping */
#define N_CTX_SKIP_FLAG 2
#define N_CTX_PRED_MODE 3
#define N_CTX_AFFINE_FLAG 2
#define N_CTX_IBC_FLAG 2

/* ---------------- bit reader (= evc_entropy.c) ---------------- */
typedef struct {
    const uint8_t *buf;
    int size;
    int cur;
    uint32_t code;
    int leftbits;
} Bsr;

static void bsr_init(Bsr *bs, const uint8_t *buf, int size) {
    bs->buf = buf; bs->size = size; bs->cur = 0; bs->code = 0;
    bs->leftbits = 0;
}

static int bsr_flush(Bsr *bs) {
    int nbytes = 4;
    int remained = bs->size - bs->cur;
    if (nbytes > remained) nbytes = remained;
    if (nbytes <= 0) { bs->code = 0; bs->leftbits = 0; return 0; }
    bs->leftbits = nbytes << 3;
    uint32_t code = 0;
    int shift = 24;
    for (int i = 0; i < nbytes; i++) {
        code |= (uint32_t)bs->buf[bs->cur + i] << shift; shift -= 8;
    }
    bs->cur += nbytes;
    bs->code = code;
    return 1;
}

static uint32_t bsr_read1(Bsr *bs) {
    if (bs->leftbits == 0) { if (!bsr_flush(bs)) return 0; }
    uint32_t code = bs->code >> 31;
    bs->code <<= 1;
    bs->leftbits -= 1;
    return code;
}

static int bsr_is_aligned(const Bsr *bs) { return (bs->leftbits & 7) == 0; }
static int bsr_at_end(const Bsr *bs) {
    return bs->cur >= bs->size && bs->leftbits == 0;
}

static uint32_t bsr_read(Bsr *bs, int size) {
    uint32_t code = 0;
    if (bs->leftbits < size) {
        code = bs->code >> (32 - size);
        size -= bs->leftbits;
        if (!bsr_flush(bs)) return 0xFFFFFFFFu;
    }
    code |= bs->code >> (32 - size);
    if (size == 32) { bs->code = 0; bs->leftbits = 0; }
    else { bs->code <<= size; bs->leftbits -= size; }
    return code;
}

/* ---------------- SBAC with the full Main context set ---------------- */
typedef struct {
    uint32_t range, value;
    uint16_t ctx[NUM_CTX_MAIN];
    Bsr *bs;
} Sbac;

/* CM_INIT seed (ref: src_base/xevd_util.c:1243-1275; sbac.py:18-31) */
static uint16_t cm_init_model(int init_value, int qp) {
    int slope = (init_value & 14) << 4;
    if (init_value & 1) slope = -slope;
    int offset = ((init_value >> 4) & 62) << 7;
    if ((init_value >> 4) & 1) offset = -offset;
    offset += 4096;
    int state = (slope * qp + offset) >> 4;
    if (state < 1) state = 1;
    if (state > 511) state = 511;
    if (state > 256) return (uint16_t)((512 - state) << 1);       /* mps 0 */
    return (uint16_t)((state << 1) + 1);                          /* mps 1 */
}

static void sbac_reset(Sbac *s, Bsr *bs, int slice_type, int slice_qp,
                       int cm_init) {
    s->bs = bs;
    s->range = 16384;
    uint32_t v = 0;
    for (int i = 0; i < 14; i++) v = ((v << 1) | bsr_read1(bs)) & 0xFFFF;
    s->value = v;
    if (!cm_init) {
        for (int i = 0; i < NUM_CTX_MAIN; i++) s->ctx[i] = PROB_INIT;
    } else {
        int qp = slice_qp < 0 ? 0 : (slice_qp > 51 ? 51 : slice_qp);
        int is_b = slice_type == SLICE_B ? 1 : 0;
        for (int i = 0; i < NUM_CTX_MAIN; i++)
            s->ctx[i] = cm_init_model(cm_init_rows[is_b][i], qp);
    }
}

#ifdef EVC_MAIN_TRACE
int evc_trace_bins = 0;
#endif
static uint32_t sbac_bin(Sbac *s, int i) {
#ifdef EVC_MAIN_TRACE
    if (evc_trace_bins)
        fprintf(stderr, "[bin] ctx=%d r=%u v=%u m=%u\n", i, s->range,
                s->value, s->ctx[i]);
#endif
    uint16_t m = s->ctx[i];
    uint32_t state = m >> 1;
    uint32_t mps = m & 1;
    uint32_t lps = (state * s->range) >> 9;
    if (lps < 437) lps = 437;
    uint32_t bin;
    s->range -= lps;
    if (s->value >= s->range) {
        bin = 1 - mps;
        s->value -= s->range;
        s->range = lps;
        state = state + ((512 - state + 16) >> 5);
        if (state > 256) { mps = 1 - mps; state = 512 - state; }
        s->ctx[i] = (uint16_t)((state << 1) + mps);
    } else {
        bin = mps;
        state = state - ((state + 16) >> 5);
        s->ctx[i] = (uint16_t)((state << 1) + mps);
    }
    while (s->range < 8192) {
        s->range <<= 1;
        s->value = ((s->value << 1) | bsr_read1(s->bs)) & 0xFFFF;
    }
    return bin;
}

static uint32_t sbac_ep(Sbac *s) {
    uint32_t bin;
    s->range >>= 1;
    if (s->value >= s->range) { bin = 1; s->value -= s->range; }
    else bin = 0;
    s->range <<= 1;
    s->value = ((s->value << 1) | bsr_read1(s->bs)) & 0xFFFF;
    return bin;
}

static uint32_t sbac_eps(Sbac *s, int num) {
    uint32_t v = 0;
    for (int i = 0; i < num; i++) v = (v << 1) | sbac_ep(s);
    return v;
}

static int sbac_trm(Sbac *s) {
    s->range -= 1;
    if (s->value >= s->range) {
        while (!bsr_is_aligned(s->bs)) {
            if (bsr_read1(s->bs) != 0) return -1;
        }
        return 1;
    }
    while (s->range < 8192) {
        s->range <<= 1;
        s->value = ((s->value << 1) | bsr_read1(s->bs)) & 0xFFFF;
    }
    return 0;
}

static uint32_t sbac_unary(Sbac *s, int base, int num_ctx) {
    uint32_t sym = sbac_bin(s, base);
    if (sym == 0) return 0;
    sym = 0;
    int idx = 0;
    for (;;) {
        if (idx < num_ctx - 1) idx++;
        uint32_t t = sbac_bin(s, base + idx);
        sym++;
        if (!t) break;
    }
    return sym;
}

static uint32_t sbac_unary_ep(Sbac *s, int max_val) {
    uint32_t sym = sbac_ep(s);
    if (sym == 0) return 0;
    sym = 0;
    int counter = 1;
    uint32_t t = 1;
    while (t) {
        t = (counter == max_val) ? 0 : sbac_ep(s);
        counter++;
        sym++;
    }
    return sym;
}

static uint32_t sbac_tu(Sbac *s, int base, int num_ctx, int max_num) {
    int idx = 0;
    if (max_num > 1) {
        for (; idx < max_num - 1; idx++) {
            int c = idx < num_ctx - 1 ? idx : num_ctx - 1;
            if (sbac_bin(s, base + c) == 0) break;
        }
    }
    return (uint32_t)idx;
}

/* ---------------- scan tables (zigzag + inverse) ---------------- */
static uint16_t m_scan_tbl[7][7][64 * 64];
static uint16_t m_iscan_tbl[7][7][64 * 64];
static int m_scan_done = 0;

static void m_init_scan(uint16_t *scan, int sx, int sy) {
    int pos = 0;
    scan[pos++] = 0;
    for (int l = 1; l < sx + sy - 1; l++) {
        int x, y;
        if (l & 1) {
            x = l < sx - 1 ? l : sx - 1;
            y = l - x;
            while (x >= 0 && y < sy) {
                scan[pos++] = (uint16_t)(y * sx + x); x--; y++;
            }
        } else {
            y = l < sy - 1 ? l : sy - 1;
            x = l - y;
            while (y >= 0 && x < sx) {
                scan[pos++] = (uint16_t)(y * sx + x); x++; y--;
            }
        }
    }
}

static void m_scan_init(void) {
    if (m_scan_done) return;
    for (int ly = 1; ly <= 6; ly++)
        for (int lx = 1; lx <= 6; lx++) {
            m_init_scan(m_scan_tbl[lx][ly], 1 << lx, 1 << ly);
            int n = 1 << (lx + ly);
            for (int p = 0; p < n; p++)
                m_iscan_tbl[lx][ly][m_scan_tbl[lx][ly][p]] = (uint16_t)p;
        }
    m_scan_done = 1;
}

/* ---------------- parameter block ---------------- */
enum {
    P_W = 0, P_H, P_LOG2_CTU, P_MIN_CUWH, P_SLICE_TYPE, P_QP,
    P_QP_U_OFF, P_QP_V_OFF, P_DQP_ENABLED, P_CFI, P_CW_SHIFT, P_CH_SHIFT,
    P_NUM_REFP0, P_NUM_REFP1, P_BDC_M8,
    P_BTT, P_SUCO, P_SUCO_MAX_DEPTH, P_SUCO_DEPTH, P_LOG2_MIN_CB,
    P_ADMVP, P_EIPD, P_CM_INIT, P_ADCC, P_ATS, P_AMVR, P_MMVD,
    P_MMVD_GROUP_ENABLE, P_ALF_CTB_BINS, P_IBC_FLAG, P_IBC_LOG_MAX,
    P_CONSTRAINED_IPRED, P_AFFINE,
    /* split_tbl[4][2]: (max, min) long-side log2 per aspect-ratio class */
    P_SPLIT_TBL,           /* 8 entries */
    NUM_PARAMS = P_SPLIT_TBL + 8
};

/* per-CU output record (int32), must match native.py consumer */
enum {
    M_X = 0, M_Y, M_LOG2W, M_LOG2H, M_PRED_MODE, M_IPM, M_IPM_C,
    M_QP, M_QP_U, M_QP_V, M_CBF_Y, M_CBF_U, M_CBF_V,
    M_REFI0, M_REFI1, M_MVP0, M_MVP1,
    M_MVD0X, M_MVD0Y, M_MVD1X, M_MVD1Y,
    M_INTER_DIR, M_TREE, M_MVR_IDX, M_BI_IDX, M_MMVD_FLAG, M_MMVD_IDX,
    M_ATS_CU, M_ATS_MODE, M_ATS_INTER,
    M_AFF_FLAG,                      /* 0 off / 1 four-param / 2 six */
    M_AFF_MVD,                       /* [2][3][2] CPMV mvds, 12 ints */
    MAIN_CU_FIELDS = M_AFF_MVD + 12
};

typedef struct {
    const int32_t *p;          /* params */
    int w, h, w_pad, h_pad, w_scu, h_scu, w_lcu, h_lcu;
    int log2_ctu, min_cuwh;
    int slice_type, qp;
    int cw_shift, ch_shift;
    int chroma_stride;
    int cm_init, admvp, eipd, adcc, ats, affine;
    const int32_t *chroma_qp_tbl_u;
    const int32_t *chroma_qp_tbl_v;
    /* outputs */
    int16_t *coef_y, *coef_u, *coef_v;
    int32_t *cu_out;
    uint8_t *map_if;
    int32_t *map_qp;
    uint8_t *map_cbfl;
    int8_t  *map_ipm;
    uint8_t *map_skip;
    uint8_t *map_ats;
    uint8_t *edge_hor, *edge_ver, *edge_hor_c, *edge_ver_c;
    uint8_t *alf_ctu_on;
    /* internal per-SCU state */
    uint8_t *cod_eco, *map_logw, *map_logh, *map_aff_eco, *map_ibc_eco;
    int n_cus;
    int qp_prev_eco;
    int err;
    Sbac sbac;
    Bsr bs;
} MDec;

static int mclip(int lo, int hi, int v) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static void m_chroma_qps(MDec *d, int qp, int *qp_u, int *qp_v) {
    int off = 6 * d->p[P_BDC_M8];
    int qi_cb = mclip(-off, 57, qp + d->p[P_QP_U_OFF]);
    int qi_cr = mclip(-off, 57, qp + d->p[P_QP_V_OFF]);
    *qp_u = d->chroma_qp_tbl_u[qi_cb + off] + off;
    *qp_v = d->chroma_qp_tbl_v[qi_cr + off] + off;
}

/* ---------------- partition geometry (partition.py) ---------------- */
#define BLOCK_11 0
#define BLOCK_12 1
#define BLOCK_14 2
#define BLOCK_TT 3

static int allow_ratio(const int32_t *tbl, int long_side, int ratio) {
    if (ratio > BLOCK_14) return 0;
    int mx = tbl[ratio * 2], mn = tbl[ratio * 2 + 1];
    return (mn <= long_side && long_side <= mx) ? 1 : 0;
}

static int allow_tri(const int32_t *tbl, int long_side) {
    int mx = tbl[BLOCK_TT * 2], mn = tbl[BLOCK_TT * 2 + 1];
    return (mn <= long_side && long_side <= mx) ? 1 : 0;
}

static int mode_cons_by_split(int split_mode, int cuw, int cuh) {
    /* (ref: src_main/xevdm_util.c:3912-3934) */
    int sw = cuw, sh = cuh;
    if (split_mode == SPLIT_BI_HOR) sh >>= 1;
    else if (split_mode == SPLIT_BI_VER) sw >>= 1;
    else if (split_mode == SPLIT_TRI_HOR) sh >>= 2;
    else if (split_mode == SPLIT_TRI_VER) sw >>= 2;
    return (sw == 4 && sh == 4) ? MC_ONLY_INTRA : MC_ALL;
}

static void check_split_mode(MDec *d, int log2_cuw, int log2_cuh,
                             int boundary, int boundary_b, int boundary_r,
                             int x, int y, int mode_cons, int allow[6]) {
    /* (ref: src_main/xevdm_util.c:1575-1687; partition.py:76-133) */
    for (int k = 0; k < 6; k++) allow[k] = 0;
    if (!d->p[P_BTT]) { allow[SPLIT_QUAD] = 1; return; }
    const int32_t *tbl = d->p + P_SPLIT_TBL;
    int cu_max = 1 << (d->log2_ctu - 1);
    int from_boundary_b = (y >= d->h - d->h % cu_max)
                          && !(x >= d->w - d->w % cu_max);
    if (log2_cuw == log2_cuh) {
        allow[SPLIT_BI_HOR] = allow_ratio(tbl, log2_cuw, 1);
        allow[SPLIT_BI_VER] = allow_ratio(tbl, log2_cuw, 1);
        allow[SPLIT_TRI_VER] = allow_tri(tbl, log2_cuw)
                               && allow_ratio(tbl, log2_cuw, 2);
        allow[SPLIT_TRI_HOR] = allow_tri(tbl, log2_cuh)
                               && allow_ratio(tbl, log2_cuh, 2);
    } else if (log2_cuw > log2_cuh) {
        allow[SPLIT_BI_HOR] = allow_ratio(tbl, log2_cuw,
                                          log2_cuw - log2_cuh + 1);
        int ls = (log2_cuw - 1) > log2_cuh ? (log2_cuw - 1) : log2_cuh;
        int ratio = (log2_cuw - 1) - log2_cuh;
        if (ratio < 0) ratio = -ratio;
        allow[SPLIT_BI_VER] = allow_ratio(tbl, ls, ratio);
        if (from_boundary_b && (ratio == 3 || ratio == 4))
            allow[SPLIT_BI_VER] = 1;
        allow[SPLIT_TRI_VER] = allow_tri(tbl, log2_cuw);
        allow[SPLIT_TRI_HOR] = 0;
    } else {
        int ls = log2_cuw > (log2_cuh - 1) ? log2_cuw : (log2_cuh - 1);
        int ratio = log2_cuw - (log2_cuh - 1);
        if (ratio < 0) ratio = -ratio;
        allow[SPLIT_BI_HOR] = allow_ratio(tbl, ls, ratio);
        allow[SPLIT_BI_VER] = allow_ratio(tbl, log2_cuh,
                                          log2_cuh - log2_cuw + 1);
        allow[SPLIT_TRI_VER] = 0;
        allow[SPLIT_TRI_HOR] = allow_tri(tbl, log2_cuh);
    }
    if (boundary) {
        allow[NO_SPLIT] = 0;
        allow[SPLIT_TRI_VER] = 0;
        allow[SPLIT_TRI_HOR] = 0;
        allow[SPLIT_QUAD] = 0;
        if (boundary_r) allow[SPLIT_BI_HOR] = allow[SPLIT_BI_VER] ? 0 : 1;
        else allow[SPLIT_BI_VER] = allow[SPLIT_BI_HOR] ? 0 : 1;
    }
    if (mode_cons == MC_ONLY_INTER) {
        int cuw = 1 << log2_cuw, cuh = 1 << log2_cuh;
        for (int m = SPLIT_BI_VER; m <= SPLIT_TRI_HOR; m++)
            if (allow[m] && mode_cons_by_split(m, cuw, cuh) != MC_ALL)
                allow[m] = 0;
    }
}

static int chroma_split_allowed(int cuw, int cuh, int split_mode) {
    /* (ref: src_main/xevdm_util.c:3820-3840) */
    if (split_mode == SPLIT_BI_VER) cuw >>= 1;
    else if (split_mode == SPLIT_BI_HOR) cuh >>= 1;
    else if (split_mode == SPLIT_TRI_VER) cuw >>= 2;
    else if (split_mode == SPLIT_TRI_HOR) cuh >>= 2;
    return (cuw * cuh >= 16 * 4) ? 1 : 0;
}

static int check_suco_cond(MDec *d, int cuw, int cuh, int split_mode,
                           int boundary) {
    /* (ref: src_main/xevdm_util.c:1702-1728) */
    int suco_log2_max = d->log2_ctu - d->p[P_SUCO_MAX_DEPTH];
    if (suco_log2_max > 6) suco_log2_max = 6;
    int log2_min_cb = d->p[P_LOG2_MIN_CB];
    int floor_ = log2_min_cb > 4 ? log2_min_cb : 4;
    int suco_log2_min = suco_log2_max - d->p[P_SUCO_DEPTH];
    if (suco_log2_min < floor_) suco_log2_min = floor_;
    int mn = cuw < cuh ? cuw : cuh;
    int mx = cuw > cuh ? cuw : cuh;
    if (mn < (1 << suco_log2_min) || mx > (1 << suco_log2_max)) return 0;
    if (boundary) return 0;
    if (split_mode == NO_SPLIT || split_mode == SPLIT_BI_HOR
        || split_mode == SPLIT_TRI_HOR) return 0;
    if (split_mode != SPLIT_QUAD && cuw <= cuh) return 0;
    return 1;
}

static int is_vertical_split(int m) {
    return m == SPLIT_BI_VER || m == SPLIT_TRI_VER || m == SPLIT_QUAD;
}

static int part_count(int m) {
    if (m == SPLIT_BI_VER || m == SPLIT_BI_HOR) return 2;
    if (m == SPLIT_TRI_VER || m == SPLIT_TRI_HOR) return 3;
    if (m == SPLIT_QUAD) return 4;
    return 1;
}

/* parts[i] = {x, y, log2w, log2h} in raster order
   (ref: src_base/xevd_util.c:1357-1480) */
static int part_structure(int split_mode, int x0, int y0, int log2_cuw,
                          int log2_cuh, int parts[4][4]) {
    int n = part_count(split_mode);
    if (split_mode == NO_SPLIT) {
        parts[0][0] = x0; parts[0][1] = y0;
        parts[0][2] = log2_cuw; parts[0][3] = log2_cuh;
        return 1;
    }
    if (split_mode == SPLIT_QUAD) {
        int hw = 1 << (log2_cuw - 1), hh = 1 << (log2_cuh - 1);
        int xy[4][2] = {{x0, y0}, {x0 + hw, y0}, {x0, y0 + hh},
                        {x0 + hw, y0 + hh}};
        for (int i = 0; i < 4; i++) {
            parts[i][0] = xy[i][0]; parts[i][1] = xy[i][1];
            parts[i][2] = log2_cuw - 1; parts[i][3] = log2_cuh - 1;
        }
        return 4;
    }
    int tri = (split_mode == SPLIT_TRI_VER || split_mode == SPLIT_TRI_HOR);
    if (is_vertical_split(split_mode)) {
        int x = x0;
        for (int i = 0; i < n; i++) {
            int lw = tri ? (i == 1 ? log2_cuw - 1 : log2_cuw - 2)
                         : log2_cuw - 1;
            parts[i][0] = x; parts[i][1] = y0;
            parts[i][2] = lw; parts[i][3] = log2_cuh;
            x += 1 << lw;
        }
    } else {
        int y = y0;
        for (int i = 0; i < n; i++) {
            int lh = tri ? (i == 1 ? log2_cuh - 1 : log2_cuh - 2)
                         : log2_cuh - 1;
            parts[i][0] = x0; parts[i][1] = y;
            parts[i][2] = log2_cuw; parts[i][3] = lh;
            y += 1 << lh;
        }
    }
    return n;
}

static void suco_order(int suco_flag, int split_mode, int order[4]) {
    /* (ref: src_main/xevdm_util.c:3482-3530) */
    int n = part_count(split_mode);
    if (!suco_flag) { for (int i = 0; i < n; i++) order[i] = i; return; }
    if (split_mode == SPLIT_QUAD) {
        order[0] = 1; order[1] = 0; order[2] = 3; order[3] = 2; return;
    }
    for (int i = 0; i < n; i++) order[i] = n - 1 - i;
}

static int tbl_log2(int v) {
    int r = 0;
    while (v > 1) { v >>= 1; r++; }
    return r;
}

/* ---------------- neighbor-count contexts (frame.py:690-731) -------- */
typedef struct { int skip, pred, mode_cons, affine, ibc; } CtxFlags;

static CtxFlags ctx_flags(MDec *d, int x_scu, int y_scu, int cuw, int cuh) {
    /* (ref: src_main/xevdm_util.c:1729-1830) */
    CtxFlags out = {0, 0, 0, 0, 0};
    if (d->slice_type == SLICE_I
        && (!d->p[P_IBC_FLAG] || cuw > (1 << d->p[P_IBC_LOG_MAX])
            || cuh > (1 << d->p[P_IBC_LOG_MAX])))
        return out;
    int scuw = cuw >> 2, scuh = cuh >> 2;
    int W = d->w_scu;
    int yb = y_scu + scuh - 1;
    int nbr[3], nn = 0;
    if (y_scu > 0 && d->cod_eco[(y_scu - 1) * W + x_scu])
        nbr[nn++] = (y_scu - 1) * W + x_scu;
    if (x_scu > 0 && d->cod_eco[yb * W + x_scu - 1])
        nbr[nn++] = yb * W + x_scu - 1;
    if (x_scu + scuw < W && d->cod_eco[yb * W + x_scu + scuw])
        nbr[nn++] = yb * W + x_scu + scuw;
    if (!nn || !d->cm_init) return out;
    int cs = 0, cp = 0, ca = 0, ci = 0;
    for (int i = 0; i < nn; i++) {
        cs += d->map_skip[nbr[i]];
        cp += d->map_if[nbr[i]];
        if (d->slice_type != SLICE_I) ca += d->map_aff_eco[nbr[i]];
        if (d->p[P_IBC_FLAG]) ci += d->map_ibc_eco[nbr[i]];
    }
    out.skip = cs < N_CTX_SKIP_FLAG - 1 ? cs : N_CTX_SKIP_FLAG - 1;
    out.pred = cp < N_CTX_PRED_MODE - 1 ? cp : N_CTX_PRED_MODE - 1;
    out.affine = ca < N_CTX_AFFINE_FLAG - 1 ? ca : N_CTX_AFFINE_FLAG - 1;
    out.ibc = ci < N_CTX_IBC_FLAG - 1 ? ci : N_CTX_IBC_FLAG - 1;
    /* mode_cons neighbor info is never filled in the reference → ctx 0;
       affine/ibc counts land with those tools */
    return out;
}

/* ---------------- EIPD MPM derivation (frame.py:136-342) ------------- */
/* (ref: src_main/xevdm_ipred.c:320-769) */
static void fill_from(const int *cands, int ncand, const int *seeds,
                      int nseed, const int mpm[2], int out[8]) {
    int ext[16];
    int cnt = 0;
    for (int i = 0; i < nseed; i++) ext[cnt++] = seeds[i];
    for (int i = 0; i < ncand; i++) {
        if (cnt > 7) break;
        int v = cands[i];
        int hit = 0;
        for (int j = 0; j < cnt; j++) {
            if (v == ext[j] || v == mpm[0] || v == mpm[1]) { hit = 1; break; }
        }
        if (!hit) ext[cnt++] = v;
    }
    for (int i = 0; i < 8; i++) out[i] = i < cnt ? ext[i] : 0;
}

static void get_mpm_main(MDec *d, int x_scu, int y_scu, int cuw, int cuh,
                         int mpm[2], int mpm_ext[8], int pims[IPD_CNT]) {
    int W = d->w_scu;
    int scuw = cuw >> 2;
    int ipm_l = IPD_DC, ipm_u = IPD_DC, ipm_r = IPD_DC;
    int valid_l = 0, valid_u = 0, valid_r = 0;
    if (x_scu > 0 && d->map_if[y_scu * W + x_scu - 1]
        && d->cod_eco[y_scu * W + x_scu - 1]) {
        ipm_l = d->map_ipm[y_scu * W + x_scu - 1];
        valid_l = 1;
    }
    if (y_scu > 0 && d->map_if[(y_scu - 1) * W + x_scu]
        && d->cod_eco[(y_scu - 1) * W + x_scu]) {
        ipm_u = d->map_ipm[(y_scu - 1) * W + x_scu];
        valid_u = 1;
    }
    if (x_scu + scuw < W && d->map_if[y_scu * W + x_scu + scuw]
        && d->cod_eco[y_scu * W + x_scu + scuw]) {
        ipm_r = d->map_ipm[y_scu * W + x_scu + scuw];
        if (valid_l && valid_u) {
            if (ipm_l == ipm_u) ipm_u = ipm_r;
            else valid_r = 1;
        } else if (!valid_l) {
            ipm_l = ipm_r;
        } else if (!valid_u) {
            ipm_u = ipm_r;
        }
        if (valid_r && (ipm_l == ipm_r || ipm_u == ipm_r)) valid_r = 0;
    }
    mpm[0] = ipm_l < ipm_u ? ipm_l : ipm_u;
    mpm[1] = ipm_l > ipm_u ? ipm_l : ipm_u;
    if (mpm[0] == mpm[1]) {
        mpm[0] = IPD_DC;
        mpm[1] = (mpm[1] == IPD_DC) ? IPD_BI : mpm[1];
    }
    for (int i = 0; i < 8; i++) mpm_ext[i] = 0;

    if (valid_r) {
        if (mpm[0] < 3 && mpm[1] < 3) {
            if (ipm_r < 3) {
                int e0 = 0;
                if (mpm[0] == IPD_DC)
                    e0 = (mpm[1] == IPD_BI) ? IPD_PLN : IPD_BI;
                else if (mpm[0] == IPD_PLN) e0 = IPD_DC;
                int tmp[8] = {e0, IPD_VER, IPD_HOR, IPD_DIA_R, IPD_DIA_L,
                              IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4};
                memcpy(mpm_ext, tmp, sizeof(tmp));
            } else {
                int lst[10] = {IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                               IPD_DIA_L, IPD_DIA_U, IPD_VER + 4,
                               IPD_HOR - 4, IPD_VER - 4, IPD_HOR + 4};
                int e0 = 0;
                if (mpm[0] == IPD_DC)
                    e0 = (mpm[1] == IPD_BI) ? IPD_PLN : IPD_BI;
                else if (mpm[0] == IPD_PLN) e0 = IPD_DC;
                int seeds[4];
                seeds[0] = e0;
                seeds[1] = ipm_r;
                seeds[2] = (ipm_r == 3 || ipm_r == 4) ? ipm_r + 1 : ipm_r - 2;
                seeds[3] = (ipm_r == IPD_CNT - 1 || ipm_r == IPD_CNT - 2)
                           ? ipm_r - 1 : ipm_r + 2;
                fill_from(lst, 10, seeds, 4, mpm, mpm_ext);
            }
        } else if (mpm[0] < 3) {
            if (ipm_r < 3) {
                int e01[2];
                if (mpm[0] == IPD_PLN) { e01[0] = IPD_BI; e01[1] = IPD_DC; }
                else {
                    e01[0] = (mpm[0] == IPD_BI) ? IPD_DC : IPD_BI;
                    e01[1] = IPD_PLN;
                }
                int rest[6];
                if (mpm[1] > IPD_CNT - 3) {
                    rest[0] = (mpm[1] == IPD_CNT - 1) ? IPD_CNT - 2
                                                      : IPD_CNT - 1;
                    rest[1] = IPD_CNT - 3; rest[2] = IPD_CNT - 4;
                    rest[3] = IPD_CNT - 5; rest[4] = IPD_HOR;
                    rest[5] = IPD_DIA_R;
                } else if (mpm[1] < 5) {
                    rest[0] = (mpm[1] == 3) ? 4 : 3;
                    rest[1] = 5; rest[2] = 6; rest[3] = 7;
                    rest[4] = IPD_VER; rest[5] = IPD_DIA_R;
                } else {
                    rest[0] = mpm[1] + 2; rest[1] = mpm[1] - 2;
                    rest[2] = mpm[1] + 1; rest[3] = mpm[1] - 1;
                    if (13 <= mpm[1] && mpm[1] <= 23) {
                        rest[4] = mpm[1] - 5; rest[5] = mpm[1] + 5;
                    } else {
                        rest[4] = mpm[1] > 23 ? mpm[1] - 5 : mpm[1] + 5;
                        rest[5] = mpm[1] > 23 ? mpm[1] - 10 : mpm[1] + 10;
                    }
                }
                mpm_ext[0] = e01[0]; mpm_ext[1] = e01[1];
                for (int i = 0; i < 6; i++) mpm_ext[2 + i] = rest[i];
            } else {
                int lst[15] = {0, 0, 0, 0, 0, 0, 0,
                               IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                               IPD_DIA_L, IPD_DIA_U, IPD_VER + 4,
                               IPD_HOR - 4};
                lst[0] = (ipm_r == 3 || ipm_r == 4) ? ipm_r + 1 : ipm_r - 2;
                lst[1] = (ipm_r == IPD_CNT - 1 || ipm_r == IPD_CNT - 2)
                         ? ipm_r - 1 : ipm_r + 2;
                lst[2] = (mpm[1] == 3 || mpm[1] == 4) ? mpm[1] + 1
                                                      : mpm[1] - 2;
                lst[3] = (mpm[1] == IPD_CNT - 1 || mpm[1] == IPD_CNT - 2)
                         ? mpm[1] - 1 : mpm[1] + 2;
                lst[4] = (ipm_r + mpm[1] + 1) >> 1;
                lst[5] = (lst[4] + ipm_r + 1) >> 1;
                lst[6] = (lst[4] + mpm[1] + 1) >> 1;
                int seeds[3];
                if (mpm[0] == IPD_PLN) {
                    seeds[0] = IPD_BI; seeds[1] = IPD_DC; seeds[2] = ipm_r;
                } else {
                    seeds[0] = (mpm[0] == IPD_BI) ? IPD_DC : IPD_BI;
                    seeds[1] = IPD_PLN; seeds[2] = ipm_r;
                }
                fill_from(lst, 15, seeds, 3, mpm, mpm_ext);
            }
        } else {
            if (ipm_r < 3) {
                int lst[15] = {0, 0, 0, 0, 0, 0, 0,
                               IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                               IPD_DIA_L, IPD_DIA_U, IPD_VER + 4,
                               IPD_HOR - 4};
                lst[0] = (mpm[0] == 3 || mpm[0] == 4) ? mpm[0] + 1
                                                      : mpm[0] - 2;
                lst[1] = (mpm[0] == IPD_CNT - 2) ? mpm[0] - 1 : mpm[0] + 2;
                lst[2] = (mpm[1] == 4) ? mpm[1] + 1 : mpm[1] - 2;
                lst[3] = (mpm[1] == IPD_CNT - 1 || mpm[1] == IPD_CNT - 2)
                         ? mpm[1] - 1 : mpm[1] + 2;
                lst[4] = (mpm[0] + mpm[1] + 1) >> 1;
                lst[5] = (lst[4] + mpm[0] + 1) >> 1;
                lst[6] = (lst[4] + mpm[1] + 1) >> 1;
                int seeds[2];
                seeds[0] = ipm_r;
                seeds[1] = (ipm_r == IPD_BI) ? IPD_DC : IPD_BI;
                fill_from(lst, 15, seeds, 2, mpm, mpm_ext);
            } else {
                int lst[16] = {0, 0, 0, 0, 0, 0, 0, 0,
                               IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                               IPD_DIA_L, IPD_DIA_U, IPD_VER + 4,
                               IPD_HOR - 4};
                lst[0] = (mpm[0] == 3 || mpm[0] == 4) ? mpm[0] + 1
                                                      : mpm[0] - 2;
                lst[1] = (mpm[0] == IPD_CNT - 2) ? mpm[0] - 1 : mpm[0] + 2;
                lst[2] = (mpm[1] == 4) ? mpm[1] + 1 : mpm[1] - 2;
                lst[3] = (mpm[1] == IPD_CNT - 1 || mpm[1] == IPD_CNT - 2)
                         ? mpm[1] - 1 : mpm[1] + 2;
                lst[4] = (ipm_r == 3 || ipm_r == 4) ? ipm_r + 1 : ipm_r - 2;
                lst[5] = (ipm_r == IPD_CNT - 1 || ipm_r == IPD_CNT - 2)
                         ? ipm_r - 1 : ipm_r + 2;
                lst[6] = (ipm_r < mpm[1]) ? ((mpm[0] + ipm_r + 1) >> 1)
                                          : ((mpm[0] + mpm[1] + 1) >> 1);
                lst[7] = (ipm_r < mpm[0]) ? ((mpm[0] + mpm[1] + 1) >> 1)
                                          : ((mpm[1] + ipm_r + 1) >> 1);
                int seeds[3] = {IPD_BI, IPD_DC, ipm_r};
                fill_from(lst, 16, seeds, 3, mpm, mpm_ext);
            }
        }
    } else {
        if (mpm[0] < 3 && mpm[1] < 3) {
            int e0 = 0;
            if (mpm[0] == IPD_DC)
                e0 = (mpm[1] == IPD_BI) ? IPD_PLN : IPD_BI;
            else if (mpm[0] == IPD_PLN) e0 = IPD_DC;
            int tmp[8] = {e0, IPD_VER, IPD_HOR, IPD_DIA_R, IPD_DIA_L,
                          IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4};
            memcpy(mpm_ext, tmp, sizeof(tmp));
        } else if (mpm[0] < 3) {
            int e01[2];
            if (mpm[0] == IPD_PLN) { e01[0] = IPD_BI; e01[1] = IPD_DC; }
            else {
                e01[0] = (mpm[0] == IPD_BI) ? IPD_DC : IPD_BI;
                e01[1] = IPD_PLN;
            }
            int rest[6];
            if (mpm[1] > IPD_CNT - 3) {
                rest[0] = (mpm[1] == IPD_CNT - 1) ? IPD_CNT - 2
                                                  : IPD_CNT - 1;
                rest[1] = IPD_CNT - 3; rest[2] = IPD_CNT - 4;
                rest[3] = IPD_CNT - 5; rest[4] = IPD_HOR; rest[5] = IPD_DIA_R;
            } else if (mpm[1] < 5) {
                rest[0] = (mpm[1] == 3) ? 4 : 3;
                rest[1] = 5; rest[2] = 6; rest[3] = 7;
                rest[4] = IPD_VER; rest[5] = IPD_DIA_R;
            } else {
                rest[0] = mpm[1] + 2; rest[1] = mpm[1] - 2;
                rest[2] = mpm[1] + 1; rest[3] = mpm[1] - 1;
                if (13 <= mpm[1] && mpm[1] <= 23) {
                    rest[4] = mpm[1] - 5; rest[5] = mpm[1] + 5;
                } else {
                    rest[4] = mpm[1] > 23 ? mpm[1] - 5 : mpm[1] + 5;
                    rest[5] = mpm[1] > 23 ? mpm[1] - 10 : mpm[1] + 10;
                }
            }
            mpm_ext[0] = e01[0]; mpm_ext[1] = e01[1];
            for (int i = 0; i < 6; i++) mpm_ext[2 + i] = rest[i];
        } else {
            int lst[15] = {0, 0, 0, 0, 0, 0, 0,
                           IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN,
                           IPD_DIA_L, IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4};
            lst[0] = (mpm[0] == 3 || mpm[0] == 4) ? mpm[0] + 1 : mpm[0] - 2;
            lst[1] = (mpm[0] == IPD_CNT - 2) ? mpm[0] - 1 : mpm[0] + 2;
            lst[2] = (mpm[1] == 4) ? mpm[1] + 1 : mpm[1] - 2;
            lst[3] = (mpm[1] == IPD_CNT - 1 || mpm[1] == IPD_CNT - 2)
                     ? mpm[1] - 1 : mpm[1] + 2;
            lst[4] = (mpm[0] + mpm[1] + 1) >> 1;
            lst[5] = (lst[4] + mpm[0] + 1) >> 1;
            lst[6] = (lst[4] + mpm[1] + 1) >> 1;
            int seeds[2] = {IPD_BI, IPD_DC};
            fill_from(lst, 15, seeds, 2, mpm, mpm_ext);
        }
    }

    int included[IPD_CNT];
    memset(included, 0, sizeof(included));
    int np = 0;
    for (int i = 0; i < 2; i++)
        if (!included[mpm[i]]) { included[mpm[i]] = 1; pims[np++] = mpm[i]; }
    for (int i = 0; i < 8; i++) {
        int v = mpm_ext[i];
        if (!included[v]) { included[v] = 1; pims[np++] = v; }
    }
    for (int i = 0; i < IPD_CNT; i++) {
        int v = intra_mode_list[i];
        if (!included[v]) { included[v] = 1; pims[np++] = v; }
    }
}

/* ---------------- syntax element readers ---------------- */
static uint32_t read_abs_mvd(MDec *d) {
    Sbac *s = &d->sbac;
    uint32_t code = sbac_bin(s, MCTX_MVD);
    if (code) return 0;
    int len = 0;
    while (!(code & 1)) {
        code = (len == 0) ? sbac_bin(s, MCTX_MVD) : sbac_ep(s);
        len++;
    }
    uint32_t val = (1u << len) - 1;
    while (len) { len--; val += sbac_ep(s) << len; }
    return val;
}

static void read_mvd(MDec *d, int mvd[2]) {
    for (int k = 0; k < 2; k++) {
        int v = (int)read_abs_mvd(d);
        if (v && sbac_ep(&d->sbac)) v = -v;
        mvd[k] = v;
    }
}

static int read_refi(MDec *d, int num_refp) {
    Sbac *s = &d->sbac;
    int ref = 0;
    if (num_refp > 1) {
        if (sbac_bin(s, MCTX_REFI)) {
            ref++;
            if (num_refp > 2 && sbac_bin(s, MCTX_REFI + 1)) {
                ref++;
                while (ref < num_refp - 1) {
                    if (!sbac_ep(s)) break;
                    ref++;
                }
            }
        }
    }
    return ref;
}

static int read_intra_dir_b(MDec *d, int x_scu, int y_scu) {
    /* Baseline 5-mode MPM permute (ref: src_base/xevd_eco.c:816-840) */
    int W = d->w_scu;
    int ipm_l = 0, ipm_u = 0;
    int scup = y_scu * W + x_scu;
    if (x_scu > 0 && d->map_if[scup - 1] && d->cod_eco[scup - 1])
        ipm_l = d->map_ipm[scup - 1] + 1;
    if (y_scu > 0 && d->map_if[scup - W] && d->cod_eco[scup - W])
        ipm_u = d->map_ipm[scup - W] + 1;
    const uint8_t *mpm = mpm_b_tbl[ipm_l][ipm_u];
    uint32_t t0 = sbac_unary(&d->sbac, MCTX_INTRA_DIR, 2);
    int ipm = 0;
    for (int i = 0; i < IPD_CNT_B; i++) if (t0 == mpm[i]) ipm = i;
    return ipm;
}

static int read_intra_dir_main(MDec *d, const int mpm[2],
                               const int mpm_ext[8], const int pims[33]) {
    /* EIPD luma mode (ref: src_base/xevd_eco.c:795-879) */
    Sbac *s = &d->sbac;
    if (sbac_bin(s, MCTX_INTRA_LUMA_PRED_MPM_FLAG))
        return mpm[sbac_bin(s, MCTX_INTRA_LUMA_PRED_MPM_IDX)];
    if (sbac_ep(s))
        return mpm_ext[sbac_eps(s, 3)];
    /* truncated binary over IPD_CNT - 10 = 23 symbols */
    int rem = (int)sbac_eps(s, 4);
    if (rem >= 16 - 7)
        rem = (rem << 1) + (int)sbac_ep(s) - (16 - 7);
    return pims[2 + 8 + rem];
}

static int read_intra_dir_c(MDec *d, int ipm_l) {
    /* EIPD chroma mode (ref: src_base/xevd_eco.c:881-910) */
    Sbac *s = &d->sbac;
    int conv = -1;
    if (ipm_l == IPD_VER) conv = IPD_VER_C;
    else if (ipm_l == IPD_HOR) conv = IPD_HOR_C;
    else if (ipm_l == IPD_DC) conv = IPD_DC_C;
    else if (ipm_l == IPD_BI) conv = IPD_BI_C;
    int ipm = 0;
    if (sbac_bin(s, MCTX_INTRA_CHROMA_PRED_MODE) == 0) {
        ipm = (int)sbac_unary_ep(s, IPD_CHROMA_CNT - 1) + 1;
        if (conv >= 0 && ipm >= conv) ipm += 1;
    }
    return ipm;
}

static int read_mmvd_data(MDec *d, int log2_cuw, int log2_cuh) {
    /* (ref: src_main/xevdm_eco.c:767-812) */
    Sbac *s = &d->sbac;
    int type_ = d->p[P_MMVD_GROUP_ENABLE]
                && !((1 << (log2_cuw + log2_cuh)) <= 32);
    int t = 0;
    if (type_) {
        t = (int)sbac_bin(s, MCTX_MMVD_GROUP_IDX);
        if (t) t += (int)sbac_bin(s, MCTX_MMVD_GROUP_IDX + 1);
    }
    int base = (int)sbac_tu(s, MCTX_MMVD_MERGE_IDX, 3, 4);
    int idx = base * 32 + t * 128;
    idx += (int)sbac_tu(s, MCTX_MMVD_DISTANCE_IDX, 7, 8) * 4;
    idx += (int)sbac_bin(s, MCTX_MMVD_DIRECTION_IDX) * 2;
    idx += (int)sbac_bin(s, MCTX_MMVD_DIRECTION_IDX + 1);
    return idx;
}

static int read_bi_idx(MDec *d) {
    /* (ref: src_base/xevd_eco.c:475-497) */
    Sbac *s = &d->sbac;
    if (sbac_bin(s, MCTX_BI_IDX)) return 0;
    return sbac_bin(s, MCTX_BI_IDX + 1) ? 1 : 2;
}

static int read_inter_pred_idc(MDec *d, int cuw, int cuh, int admvp) {
    /* (ref: src_main/xevdm_eco.c:1143-1171) */
    Sbac *s = &d->sbac;
    uint32_t tmp = 1;
    /* check_bi_applicability: SLICE_B && (!admvp || cuw+cuh > 12) */
    if (!admvp || (cuw + cuh > 12))
        tmp = sbac_bin(s, MCTX_INTER_DIR);
    if (!tmp) return PRED_BI;
    tmp = sbac_bin(s, MCTX_INTER_DIR + 1);
    return tmp ? PRED_L1 : PRED_L0;
}

static int read_dqp(MDec *d) {
    Sbac *s = &d->sbac;
    int dqp = (int)sbac_unary(s, MCTX_DELTA_QP, 1);
    if (dqp > 0 && sbac_ep(s)) dqp = -dqp;
    return dqp;
}

/* ---------------- ADCC context helpers (frame.py:351-408) ----------- */
static int adcc_nbr_sum(const int32_t *coef, int blkpos, int width,
                        int height, int thresh) {
    int pos_y = blkpos / width, pos_x = blkpos % width;
    int n = 0;
    if (pos_x < width - 1) {
        n += abs(coef[blkpos + 1]) > thresh;
        if (pos_x < width - 2) n += abs(coef[blkpos + 2]) > thresh;
        if (pos_y < height - 1) n += abs(coef[blkpos + width + 1]) > thresh;
    }
    if (pos_y < height - 1) {
        n += abs(coef[blkpos + width]) > thresh;
        if (pos_y < height - 2) n += abs(coef[blkpos + 2 * width]) > thresh;
    }
    return n;
}

static int adcc_ctx_sig(const int32_t *coef, int blkpos, int width,
                        int height, int ch_type) {
    /* (ref: src_main/xevdm_util.c:3190-3242) */
    int pos_y = blkpos / width, pos_x = blkpos % width;
    int diag = pos_x + pos_y;
    int ctx_idx = adcc_nbr_sum(coef, blkpos, width, height, 0);
    if (ctx_idx > 4) ctx_idx = 4;
    ctx_idx += 1;
    if (diag < 2 && ctx_idx > 2) ctx_idx = 2;
    int ctx_ofs;
    if (ch_type == 0) ctx_ofs = diag < 2 ? 0 : (diag < 5 ? 2 : 7);
    else ctx_ofs = diag < 2 ? 0 : 2;
    return ctx_ofs + ctx_idx;
}

static int adcc_ctx_gtx(const int32_t *coef, int blkpos, int width,
                        int height, int ch_type, int thresh) {
    /* (ref: src_main/xevdm_util.c:3244-3324) */
    int pos_y = blkpos / width, pos_x = blkpos % width;
    int diag = pos_x + pos_y;
    int n = adcc_nbr_sum(coef, blkpos, width, height, thresh);
    if (n > 3) n = 3;
    n += 1;
    if (ch_type == 0) n += diag < 3 ? 0 : (diag < 10 ? 4 : 8);
    return n;
}

static int adcc_rice_para(const int32_t *coef, int blkpos, int width,
                          int height, int base_level) {
    /* (ref: src_main/xevdm_util.c:3379-3412) */
    int pos_y = blkpos / width, pos_x = blkpos % width;
    int s = 0;
    if (pos_x < width - 1) {
        s += abs(coef[blkpos + 1]);
        if (pos_x < width - 2) s += abs(coef[blkpos + 2]);
        if (pos_y < height - 1) s += abs(coef[blkpos + width + 1]);
    }
    if (pos_y < height - 1) {
        s += abs(coef[blkpos + width]);
        if (pos_y < height - 2) s += abs(coef[blkpos + 2 * width]);
    }
    s -= 5 * base_level;
    if (s < 0) s = 0;
    if (s > 31) s = 31;
    return adcc_go_rice_para[s];
}

/* last_sig_coeff ctx offsets/shifts (tables.py:387-407;
   ref: src_base/xevd_util.c:1194-1219) */
static void adcc_last_pos_para(int ch_type, int width, int height,
                               int *off_x, int *off_y, int *sh_x, int *sh_y) {
    int cw = tbl_log2(width) - 2;
    if (cw < 0) cw = 0;
    int ch = tbl_log2(height) - 2;
    if (ch < 0) ch = 0;
    if (ch_type == 0) {
        *off_x = (cw * 3) + ((cw + 1) >> 2);
        *off_y = (ch * 3) + ((ch + 1) >> 2);
        *sh_x = (cw + 3) >> 2;
        *sh_y = (ch + 3) >> 2;
        if (cw >= 4) {
            *off_x += ((width >> 6) << 1) + (width >> 7);
            *sh_x = 2;
        }
        if (ch >= 4) {
            *off_y += ((height >> 6) << 1) + (height >> 7);
            *sh_y = 2;
        }
    } else {
        *off_x = 0; *off_y = 0;
        *sh_x = cw - ((width >> 4) >= 2 ? tbl_log2(width >> 4) : 0);
        *sh_y = ch - ((height >> 4) >= 2 ? tbl_log2(height >> 4) : 0);
    }
}

/* ---------------- coefficient blocks ---------------- */
/* run/level zigzag with optional CM_INIT ctx selection
   (ref: src_base/xevd_eco.c:354-411, src_main/xevdm_eco.c:303-352) */
static void read_coef_rl(MDec *d, int16_t *plane, int stride, int bx,
                         int by, int log2_w, int log2_h, int ch_type) {
    Sbac *s = &d->sbac;
    const uint16_t *scanp = m_scan_tbl[log2_w][log2_h];
    int num_coeff = 1 << (log2_w + log2_h);
    int ctx_last = ch_type == 0 ? 0 : 1;
    int w = 1 << log2_w;
    int pos = 0;
    int prev_level = 6;
    for (;;) {
        int t0;
        if (d->cm_init) {
            int pl = prev_level - 1;
            if (pl > 5) pl = 5;
            t0 = (pl << 1) + (ch_type == 0 ? 0 : 12);
        } else {
            t0 = ch_type == 0 ? 0 : 2;
        }
        int run = (int)sbac_unary(s, MCTX_RUN + t0, 2);
        pos += run;
        int level = (int)sbac_unary(s, MCTX_LEVEL + t0, 2) + 1;
        prev_level = level;
        int sign = (int)sbac_ep(s);
        int p = scanp[pos];
        plane[(by + p / w) * stride + bx + (p % w)] =
            (int16_t)(sign ? -level : level);
        if (pos >= num_coeff - 1) break;
        pos++;
        if (sbac_bin(s, MCTX_LAST + ctx_last)) break;
    }
}

static int read_remain_exgolomb(MDec *d, int rparam) {
    /* (ref: src_main/xevdm_eco.c:464-491) */
    Sbac *s = &d->sbac;
    int prefix = 0;
    while (sbac_ep(s)) prefix++;
    int rng = adcc_go_rice_range[rparam];
    if (prefix < rng) {
        int suffix = rparam ? (int)sbac_eps(s, rparam) : 0;
        return (prefix << rparam) + suffix;
    }
    int suffix = (int)sbac_eps(s, prefix - rng + rparam);
    return (((1 << (prefix - rng)) + rng - 1) << rparam) + suffix;
}

/* ADCC coefficient decode (ref: src_main/xevdm_eco.c:492-693) */
static void read_coef_adcc(MDec *d, int16_t *plane, int stride, int bx,
                           int by, int log2_w, int log2_h, int ch_type) {
    Sbac *s = &d->sbac;
    int width = 1 << log2_w, height = 1 << log2_h;
    int32_t coef[64 * 64];
    memset(coef, 0, sizeof(int32_t) * width * height);

    /* last significant position */
    int base_last = ch_type == 0 ? 0
                    : (d->cm_init ? NUM_CTX_LAST_SIG_COEFF_LUMA : 11);
    int off_x = 0, off_y = 0, sh_x = 0, sh_y = 0;
    if (d->cm_init)
        adcc_last_pos_para(ch_type, width, height, &off_x, &off_y,
                           &sh_x, &sh_y);
    int pos_x = 0;
    while (pos_x < adcc_group_idx[width - 1]) {
        if (!sbac_bin(s, MCTX_LAST_SIG_COEFF_X_PREFIX + base_last + off_x
                         + (pos_x >> sh_x)))
            break;
        pos_x++;
    }
    int pos_y = 0;
    while (pos_y < adcc_group_idx[height - 1]) {
        if (!sbac_bin(s, MCTX_LAST_SIG_COEFF_Y_PREFIX + base_last + off_y
                         + (pos_y >> sh_y)))
            break;
        pos_y++;
    }
    if (pos_x > 3) {
        int cnt = (pos_x - 2) >> 1;
        int tmp = (int)sbac_eps(s, cnt);
        pos_x = adcc_min_in_group[pos_x] + tmp;
    }
    if (pos_y > 3) {
        int cnt = (pos_y - 2) >> 1;
        int tmp = (int)sbac_eps(s, cnt);
        pos_y = adcc_min_in_group[pos_y] + tmp;
    }

    const uint16_t *scan = m_scan_tbl[log2_w][log2_h];
    const uint16_t *iscan = m_iscan_tbl[log2_w][log2_h];
    int num_coeff = (int)iscan[pos_x + pos_y * width] + 1;

    int log2_block = log2_w < log2_h ? log2_w : log2_h;
    int sig_base, gtx_base;
    if (d->cm_init) {
        int offset0 = log2_block <= 2 ? 0
            : NUM_CTX_SIG_COEFF_LUMA_TU
              << ((log2_block - 3) < 1 ? (log2_block - 3) : 1);
        sig_base = ch_type == 0 ? offset0 : NUM_CTX_SIG_COEFF_LUMA;
        gtx_base = ch_type == 0 ? 0 : NUM_CTX_GTX_LUMA;
    } else {
        sig_base = ch_type == 0 ? 0 : 1;
        gtx_base = ch_type == 0 ? 0 : 1;
    }

    int last_scan_set = (num_coeff - 1) >> LOG2_CG_SIZE;
    int scan_pos_last = num_coeff - 1;
    int ipos = scan_pos_last;
    int is_last_nz = 0;
    int pos_last = 0;
    int ctx_gtA = 0, ctx_gtB = 0;

    for (int sub_set = last_scan_set; sub_set >= 0; sub_set--) {
        int sub_pos = sub_set << LOG2_CG_SIZE;
        int pos[1 << LOG2_CG_SIZE];
        int abs_coef[1 << LOG2_CG_SIZE];
        int num_nz = 0;
        while (ipos >= sub_pos) {
            int blkpos = scan[ipos];
            int sig;
            if (ipos == scan_pos_last) {
                sig = 1;
            } else {
                int ctx_sig = d->cm_init
                    ? adcc_ctx_sig(coef, blkpos, width, height, ch_type) : 0;
                sig = (int)sbac_bin(s, MCTX_SIG_COEFF_FLAG + sig_base
                                       + ctx_sig);
            }
            coef[blkpos] = sig;
            if (sig) {
                pos[num_nz++] = blkpos;
                if (!is_last_nz) { pos_last = blkpos; is_last_nz = 1; }
            }
            ipos--;
        }
        if (num_nz == 0) continue;
        for (int i = 0; i < num_nz; i++) abs_coef[i] = 1;
        int escape = 0;
        int first_c2 = -1;
        int lim = num_nz < CAFLAG_NUMBER ? num_nz : CAFLAG_NUMBER;
        for (int idx = 0; idx < lim; idx++) {
            if (pos[idx] != pos_last && d->cm_init)
                ctx_gtA = adcc_ctx_gtx(coef, pos[idx], width, height,
                                       ch_type, 1);
            else if (pos[idx] != pos_last)
                ctx_gtA = 0;
            int gtA = (int)sbac_bin(s, MCTX_COEFF_ABS_LEVEL_GREATERAB_FLAG
                                       + gtx_base + ctx_gtA);
            coef[pos[idx]] += gtA;
            abs_coef[idx] = gtA + 1;
            if (gtA) {
                if (first_c2 == -1) first_c2 = idx;
                else escape = 1;
            }
        }
        if (first_c2 != -1) {
            if (pos[first_c2] != pos_last && d->cm_init)
                ctx_gtB = adcc_ctx_gtx(coef, pos[first_c2], width, height,
                                       ch_type, 2);
            else if (pos[first_c2] != pos_last)
                ctx_gtB = 0;
            int gtB = (int)sbac_bin(s, MCTX_COEFF_ABS_LEVEL_GREATERAB_FLAG
                                       + gtx_base + ctx_gtB);
            coef[pos[first_c2]] += gtB;
            abs_coef[first_c2] = gtB + 2;
            if (gtB) escape = 1;
        }
        if (num_nz > CAFLAG_NUMBER) escape = 1;
        if (escape) {
            int first2 = 1;
            for (int idx = 0; idx < num_nz; idx++) {
                int base_level = idx < CAFLAG_NUMBER ? (2 + first2) : 1;
                if (abs_coef[idx] >= base_level) {
                    int rparam = adcc_rice_para(coef, pos[idx], width,
                                                height, base_level);
                    int rem = read_remain_exgolomb(d, rparam);
                    coef[pos[idx]] = rem + base_level;
                    abs_coef[idx] = rem + base_level;
                }
                if (abs_coef[idx] >= 2) first2 = 0;
            }
        }
        uint32_t signs = sbac_eps(s, num_nz);
        for (int idx = 0; idx < num_nz; idx++) {
            int v = abs_coef[idx];
            if ((signs >> (num_nz - 1 - idx)) & 1) v = -v;
            coef[pos[idx]] = v;
        }
    }
    /* store with s16 wraparound (coefficients are s16 in the reference) */
    for (int yy = 0; yy < height; yy++)
        for (int xx = 0; xx < width; xx++) {
            int32_t v = coef[yy * width + xx];
            plane[(by + yy) * stride + bx + xx] = (int16_t)(uint16_t)v;
        }
}

static void read_coef_block(MDec *d, int16_t *plane, int stride, int bx,
                            int by, int log2_w, int log2_h, int ch_type) {
    if (d->adcc)
        read_coef_adcc(d, plane, stride, bx, by, log2_w, log2_h, ch_type);
    else
        read_coef_rl(d, plane, stride, bx, by, log2_w, log2_h, ch_type);
}

/* ---------------- ATS geometry (tables.py:469-530) ---------------- */
static void ats_inter_tu_size(int info, int log2_cuw, int log2_cuh,
                              int *ltw, int *lth) {
    int idx = info & 0xF;
    if (idx == 0) {
        *ltw = log2_cuw < MAX_TR_LOG2 ? log2_cuw : MAX_TR_LOG2;
        *lth = log2_cuh < MAX_TR_LOG2 ? log2_cuh : MAX_TR_LOG2;
        return;
    }
    int horizontal = (idx == 2 || idx == 4);
    int quad = (idx == 3 || idx == 4);
    if (horizontal) {
        *ltw = log2_cuw < MAX_TR_LOG2 ? log2_cuw : MAX_TR_LOG2;
        int lh = log2_cuh - (quad ? 2 : 1);
        *lth = lh < MAX_TR_LOG2 ? lh : MAX_TR_LOG2;
    } else {
        int lw = log2_cuw - (quad ? 2 : 1);
        *ltw = lw < MAX_TR_LOG2 ? lw : MAX_TR_LOG2;
        *lth = log2_cuh < MAX_TR_LOG2 ? log2_cuh : MAX_TR_LOG2;
    }
}

static void ats_inter_tu_offset(int info, int log2_cuw, int log2_cuh,
                                int *xo, int *yo) {
    int idx = info & 0xF;
    int pos = (info >> 4) & 0xF;
    *xo = 0; *yo = 0;
    if (idx == 0) return;
    int cuw = 1 << log2_cuw, cuh = 1 << log2_cuh;
    int horizontal = (idx == 2 || idx == 4);
    int quad = (idx == 3 || idx == 4);
    if (horizontal) {
        if (pos != 0) *yo = cuh - (quad ? cuh / 4 : cuh / 2);
    } else {
        if (pos != 0) *xo = cuw - (quad ? cuw / 4 : cuw / 2);
    }
}

static int check_ats_inter_avail(int cuw, int cuh, int pred_mode,
                                 int tool_ats) {
    /* (ref: src_main/xevdm_util.c:3565-3583; IBC CUs carry no
       ats_inter either) */
    if (!tool_ats || pred_mode == MODE_INTRA || pred_mode == MODE_IBC
        || cuw > (1 << MAX_TR_LOG2) || cuh > (1 << MAX_TR_LOG2))
        return 0;
    int mode_vert = cuw >= 8;
    int mode_vert_quad = cuw >= 16;
    int mode_hori = cuh >= 8;
    int mode_hori_quad = cuh >= 16;
    return mode_vert | (mode_hori << 1) | (mode_vert_quad << 2)
           | (mode_hori_quad << 3);
}

static int read_ats_inter_info(MDec *d, int log2_cuw, int log2_cuh,
                               int avail) {
    /* (ref: src_main/xevdm_eco.c eco_ats_inter_info) */
    Sbac *s = &d->sbac;
    int mode_vert = avail & 1;
    int mode_hori = (avail >> 1) & 1;
    int mode_vert_quad = (avail >> 2) & 1;
    int mode_hori_quad = (avail >> 3) & 1;
    int ctx_f = d->cm_init ? (log2_cuw + log2_cuh >= 8 ? 0 : 1) : 0;
    int ctx_h = d->cm_init
        ? (log2_cuw == log2_cuh ? 0 : (log2_cuw < log2_cuh ? 1 : 2)) : 0;
    if (!sbac_bin(s, MCTX_ATS_CU_INTER_FLAG + ctx_f)) return 0;
    int quad = 0;
    if ((mode_vert_quad || mode_hori_quad) && (mode_vert || mode_hori))
        quad = (int)sbac_bin(s, MCTX_ATS_CU_INTER_QUAD_FLAG);
    int hor;
    if ((quad && mode_vert_quad && mode_hori_quad)
        || (!quad && mode_vert && mode_hori))
        hor = (int)sbac_bin(s, MCTX_ATS_CU_INTER_HOR_FLAG + ctx_h);
    else
        hor = ((quad && mode_hori_quad) || (!quad && mode_hori)) ? 1 : 0;
    int pos = (int)sbac_bin(s, MCTX_ATS_CU_INTER_POS_FLAG);
    int idx = (quad ? 2 : 0) + (hor ? 1 : 0) + 1;
    return idx + (pos << 4);
}

/* ---------------- cbf + coef driver (frame.py:1085-1195) ------------ */
static void read_cbf(MDec *d, int pred_mode, int tree_type, int is_sub,
                     int sub_pos, int b_no_cbf, int cbf[3], int *all_zero) {
    /* (ref: src_main/xevdm_eco.c:203-301) */
    Sbac *s = &d->sbac;
    int chroma = d->p[P_CFI] != 0;
    cbf[0] = cbf[1] = cbf[2] = 0;
    *all_zero = 0;
    if (pred_mode != MODE_INTRA && tree_type == TREE_LC) {
        if (!b_no_cbf && sub_pos == 0) {
            if (sbac_bin(s, MCTX_CBF_ALL) == 0) { *all_zero = 1; return; }
        }
        if (chroma) {
            cbf[1] = (int)sbac_bin(s, MCTX_CBF_CB);
            cbf[2] = (int)sbac_bin(s, MCTX_CBF_CR);
        }
        if (cbf[1] + cbf[2] == 0 && !is_sub) cbf[0] = 1;
        else cbf[0] = (int)sbac_bin(s, MCTX_CBF_LUMA);
    } else {
        if (tree_type != TREE_L && chroma) {
            cbf[1] = (int)sbac_bin(s, MCTX_CBF_CB);
            cbf[2] = (int)sbac_bin(s, MCTX_CBF_CR);
        }
        if (tree_type != TREE_C)
            cbf[0] = (int)sbac_bin(s, MCTX_CBF_LUMA);
    }
}

typedef struct { int ats_cu, ats_mode, ats_inter; } AtsInfo;

static int decode_coef(MDec *d, int x, int y, int log2_cuw, int log2_cuh,
                       int pred_mode, int tree_type, int *qp_out,
                       int cbf_any[3], AtsInfo *ats) {
    /* cbf + dqp + coef blocks with the >MAX_TR sub-TU loop
       (ref: src_base/xevd_eco.c:256-352, src_main/xevdm_eco.c:820-984) */
    int b_no_cbf = d->admvp && pred_mode == MODE_DIR;
    int log2_w_sub = log2_cuw < MAX_TR_LOG2 ? log2_cuw : MAX_TR_LOG2;
    int log2_h_sub = log2_cuh < MAX_TR_LOG2 ? log2_cuh : MAX_TR_LOG2;
    int loop_w = 1 << (log2_cuw - log2_w_sub);
    int loop_h = 1 << (log2_cuh - log2_h_sub);
    int is_sub = loop_w * loop_h > 1;
    int qp = d->qp_prev_eco;
    int ats_avail = pred_mode != MODE_INTRA
        ? check_ats_inter_avail(1 << log2_cuw, 1 << log2_cuh, pred_mode,
                                d->ats)
        : 0;
#ifdef EVC_MAIN_TRACE
    {
        extern int evc_trace_bins;
        if (evc_trace_bins)
            fprintf(stderr, "[coef] pm=%d ats_avail=%d\n", pred_mode,
                    ats_avail);
    }
#endif
    ats->ats_cu = ats->ats_mode = ats->ats_inter = 0;
    cbf_any[0] = cbf_any[1] = cbf_any[2] = 0;
    int cbf_all = 1;
    for (int j = 0; j < loop_h; j++) {
        for (int i = 0; i < loop_w; i++) {
            int cbf[3] = {0, 0, 0};
            if (cbf_all) {
                int zero;
                read_cbf(d, pred_mode, tree_type, is_sub, j + i, b_no_cbf,
                         cbf, &zero);
                if (zero) {
                    *qp_out = d->qp_prev_eco;
                    cbf_any[0] = cbf_any[1] = cbf_any[2] = 0;
                    return 0;
                }
            }
            if (d->p[P_DQP_ENABLED] && (cbf[0] || cbf[1] || cbf[2])) {
                int dqp = read_dqp(d);
                qp = (d->qp_prev_eco + dqp + 52) % 52;
                d->qp_prev_eco = qp;
            } else {
                qp = d->qp_prev_eco;
            }
            /* ATS syntax (ref: src_main/xevdm_eco.c:889-934) */
            int ats_cu = 0, ats_mode = 0, ats_inter = 0;
            if (d->ats && cbf[0] && log2_cuw <= 5 && log2_cuh <= 5
                && pred_mode == MODE_INTRA) {
                ats_cu = (int)sbac_ep(&d->sbac);
                if (ats_cu) {
                    int hbit = (int)sbac_bin(&d->sbac, MCTX_ATS_MODE);
                    int vbit = (int)sbac_bin(&d->sbac, MCTX_ATS_MODE);
                    ats_mode = (hbit << 1) | vbit;
                }
            }
            if (ats_avail && (cbf[0] || cbf[1] || cbf[2]))
                ats_inter = read_ats_inter_info(d, log2_cuw, log2_cuh,
                                                ats_avail);
            ats->ats_cu = ats_cu;
            ats->ats_mode = ats_mode;
            ats->ats_inter = ats_inter;

            int xs = x + (i << log2_w_sub);
            int ys = y + (j << log2_h_sub);
            if (cbf[0]) {
                int ltw, lth, xo, yo;
                ats_inter_tu_size(ats_inter, log2_w_sub, log2_h_sub,
                                  &ltw, &lth);
                ats_inter_tu_offset(ats_inter, log2_w_sub, log2_h_sub,
                                    &xo, &yo);
                read_coef_block(d, d->coef_y, d->w_pad, xs + xo, ys + yo,
                                ltw, lth, 0);
            }
            if (cbf[1] || cbf[2]) {
                int lw = log2_w_sub - d->cw_shift;
                int lh = log2_h_sub - d->ch_shift;
                int ltw, lth, xo, yo;
                ats_inter_tu_size(ats_inter, lw, lh, &ltw, &lth);
                ats_inter_tu_offset(ats_inter, lw, lh, &xo, &yo);
                int xc = (xs >> d->cw_shift) + xo;
                int yc = (ys >> d->ch_shift) + yo;
                if (cbf[1])
                    read_coef_block(d, d->coef_u, d->chroma_stride, xc, yc,
                                    ltw, lth, 1);
                if (cbf[2])
                    read_coef_block(d, d->coef_v, d->chroma_stride, xc, yc,
                                    ltw, lth, 1);
            }
            cbf_any[0] |= cbf[0];
            cbf_any[1] |= cbf[1];
            cbf_any[2] |= cbf[2];
        }
    }
    *qp_out = qp;
    return 0;
}

/* ---------------- CU syntax (frame.py:734-953) ---------------- */
static void decode_cu(MDec *d, int x, int y, int log2_cuw, int log2_cuh,
                      int tree_type, int mode_cons) {
    /* (ref: src_main/xevdm_eco.c:1467-1819) */
#ifdef EVC_MAIN_TRACE
    extern int evc_trace_bins;
    if (x == 160 && y == 4) evc_trace_bins = 1;
#endif
    Sbac *s = &d->sbac;
    int cuw = 1 << log2_cuw, cuh = 1 << log2_cuh;
    int x_scu = x >> 2, y_scu = y >> 2;
    int scuw = cuw >> 2, scuh = cuh >> 2;
    int W = d->w_scu;

    int pred_mode = MODE_INTRA;
    int mvp_idx0 = 0, mvp_idx1 = 0;
    int mvd[2][2] = {{0, 0}, {0, 0}};
    int refi0 = REFI_INVALID, refi1 = REFI_INVALID;
    int inter_dir = 0, ipm = 0, ipm_c = -1;
    int cbf[3] = {0, 0, 0};
    int only_intra = mode_cons == MC_ONLY_INTRA;
    int check_luma = tree_type != TREE_C;
    int check_chroma = tree_type != TREE_L;
    int mvr_idx = 0, bi_idx = 0, mmvd_flag = 0, mmvd_idx = 0;
    int aff_flag = 0;
    int aff_mvd[2][3][2];
    int qp;
    AtsInfo ats = {0, 0, 0};
    memset(aff_mvd, 0, sizeof(aff_mvd));

    CtxFlags cf = ctx_flags(d, x_scu, y_scu, cuw, cuh);

    if (d->slice_type != SLICE_I && !only_intra) {
        if (sbac_bin(s, MCTX_SKIP_FLAG + cf.skip)) pred_mode = MODE_SKIP;
    }

    if (pred_mode == MODE_SKIP) {
        if (!d->admvp) {
            mvp_idx0 = (int)sbac_tu(s, MCTX_MVP_IDX, 3, 4);
            if (d->slice_type == SLICE_B)
                mvp_idx1 = (int)sbac_tu(s, MCTX_MVP_IDX, 3, 4);
        } else {
            if (d->p[P_MMVD])
                mmvd_flag = (int)sbac_bin(s, MCTX_MMVD_FLAG);
            if (mmvd_flag) {
                mmvd_idx = read_mmvd_data(d, log2_cuw, log2_cuh);
            } else {
                if (d->affine && cuw >= 8 && cuh >= 8)
                    aff_flag = (int)sbac_bin(s, MCTX_AFFINE_FLAG
                                                + cf.affine);
                if (aff_flag) {
                    mvp_idx0 = (int)sbac_tu(s, MCTX_AFFINE_MRG, 5, 5);
                } else {
                    mvp_idx0 = (int)sbac_tu(s, MCTX_MERGE_IDX, 5, 6);
                    mvp_idx1 = mvp_idx0;
                }
            }
        }
        qp = d->p[P_DQP_ENABLED] ? d->qp_prev_eco : d->qp;
    } else {
        /* pred mode flag + IBC (ref: src_main/xevdm_eco.c:1400-1452) */
        int pred_bin = 0;
        if (mode_cons == MC_ONLY_INTER) {
            pred_mode = MODE_INTER;
        } else if (d->slice_type != SLICE_I && !only_intra) {
            pred_bin = (int)sbac_bin(s, MCTX_PRED_MODE + cf.pred);
            pred_mode = pred_bin ? MODE_INTRA : MODE_INTER;
        } else {
            pred_mode = MODE_INTRA;
        }
        if (d->p[P_IBC_FLAG] && log2_cuw <= d->p[P_IBC_LOG_MAX]
            && log2_cuh <= d->p[P_IBC_LOG_MAX] && tree_type != TREE_C
            && mode_cons != MC_ONLY_INTER
            && !(mode_cons == MC_ALL && pred_bin)) {
            if (sbac_bin(s, MCTX_IBC_FLAG + cf.ibc))
                pred_mode = MODE_IBC;
        }

        if (pred_mode == MODE_INTER) {
            if (d->p[P_AMVR])
                mvr_idx = (int)sbac_tu(s, MCTX_MVR_IDX, 5, 5);
            if (d->slice_type == SLICE_B && !d->admvp) {
                if (sbac_bin(s, MCTX_DIRECT_MODE_FLAG)) inter_dir = PRED_DIR;
            } else if (d->admvp && mvr_idx == 0) {
                if (sbac_bin(s, MCTX_MERGE_MODE_FLAG)) inter_dir = PRED_DIR;
            }
            if (inter_dir == PRED_DIR && d->admvp) {
                /* merge (ref: src_main/xevdm_eco.c:1608-1640) */
                if (d->p[P_MMVD])
                    mmvd_flag = (int)sbac_bin(s, MCTX_MMVD_FLAG);
                if (mmvd_flag) {
                    mmvd_idx = read_mmvd_data(d, log2_cuw, log2_cuh);
                } else {
                    if (d->affine && cuw >= 8 && cuh >= 8)
                        aff_flag = (int)sbac_bin(s, MCTX_AFFINE_FLAG
                                                    + cf.affine);
                    if (aff_flag) {
                        mvp_idx0 = (int)sbac_tu(s, MCTX_AFFINE_MRG, 5, 5);
                    } else {
                        mvp_idx0 = (int)sbac_tu(s, MCTX_MERGE_IDX, 5, 6);
                        mvp_idx1 = mvp_idx0;
                    }
                }
                pred_mode = MODE_DIR;
            } else if (inter_dir != PRED_DIR) {
                if (d->slice_type == SLICE_B)
                    inter_dir = read_inter_pred_idc(d, cuw, cuh, d->admvp);
                else
                    inter_dir = PRED_L0;
                if (d->affine && cuw >= 16 && cuh >= 16 && mvr_idx == 0)
                    aff_flag = (int)sbac_bin(s, MCTX_AFFINE_FLAG
                                                + cf.affine);
                if (aff_flag) {
                    /* affine AMVP (ref: xevdm_eco.c:1649-1694) */
                    aff_flag += (int)sbac_bin(s, MCTX_AFFINE_MODE);
                    for (int lidx = 0; lidx < 2; lidx++) {
                        if (((inter_dir + 1) >> lidx) & 1) {
                            int nr = lidx == 0 ? d->p[P_NUM_REFP0]
                                               : d->p[P_NUM_REFP1];
                            int r = read_refi(d, nr);
                            int mi = (int)sbac_tu(s, MCTX_AFFINE_MVP_IDX,
                                                  1, 2);
                            if (lidx == 0) { refi0 = r; mvp_idx0 = mi; }
                            else { refi1 = r; mvp_idx1 = mi; }
                            int bzero = (int)sbac_bin(
                                s, MCTX_AFFINE_MVD_FLAG + lidx);
                            for (int v = 0; v < aff_flag + 1; v++) {
                                if (!bzero)
                                    read_mvd(d, aff_mvd[lidx][v]);
                            }
                        }
                    }
                } else if (!d->admvp) {
                    for (int lidx = 0; lidx < 2; lidx++) {
                        if (((inter_dir + 1) >> lidx) & 1) {
                            int nr = lidx == 0 ? d->p[P_NUM_REFP0]
                                               : d->p[P_NUM_REFP1];
                            int r = read_refi(d, nr);
                            int mi = (int)sbac_tu(s, MCTX_MVP_IDX, 3, 4);
                            if (lidx == 0) { refi0 = r; mvp_idx0 = mi; }
                            else { refi1 = r; mvp_idx1 = mi; }
                            read_mvd(d, mvd[lidx]);
                        }
                    }
                } else {
                    if (inter_dir == PRED_BI)
                        bi_idx = read_bi_idx(d) + 1;
                    for (int lidx = 0; lidx < 2; lidx++) {
                        if (((inter_dir + 1) >> lidx) & 1) {
                            int nr = lidx == 0 ? d->p[P_NUM_REFP0]
                                               : d->p[P_NUM_REFP1];
                            if (bi_idx != 2 && bi_idx != 3) {
                                int r = read_refi(d, nr);
                                if (lidx == 0) refi0 = r; else refi1 = r;
                            }
                            if (bi_idx != 2 + lidx)
                                read_mvd(d, mvd[lidx]);
                        }
                    }
                }
            }
        } else if (pred_mode == MODE_IBC) {
            /* block vector as one raw mvd (ref: xevdm_eco.c:1789-1800) */
            read_mvd(d, mvd[0]);
        } else if (!d->eipd) {
            if (check_luma) {
                ipm = read_intra_dir_b(d, x_scu, y_scu);
            } else {
                int yc = y_scu + (scuh >> 1);
                int xc = x_scu + (scuw >> 1);
                ipm = d->map_ipm[yc * W + xc];
            }
        } else {
            if (check_luma) {
                int mpm[2], mpm_ext[8], pims[IPD_CNT];
                get_mpm_main(d, x_scu, y_scu, cuw, cuh, mpm, mpm_ext, pims);
                ipm = read_intra_dir_main(d, mpm, mpm_ext, pims);
            } else {
                /* TREE_C: co-located luma mode
                   (ref: src_main/xevdm_eco.c:1743-1757) */
                int yc = y_scu + (scuh >> 1);
                int xc = x_scu + (scuw >> 1);
                if (d->map_if[yc * W + xc]) ipm = d->map_ipm[yc * W + xc];
                else ipm = IPD_DC;
            }
            if (check_chroma && d->p[P_CFI] != 0)
                ipm_c = read_intra_dir_c(d, ipm);
        }
        decode_coef(d, x, y, log2_cuw, log2_cuh, pred_mode, tree_type,
                    &qp, cbf, &ats);
    }

    int qp_u, qp_v;
    m_chroma_qps(d, qp, &qp_u, &qp_v);

    int32_t *rec = d->cu_out + (int64_t)d->n_cus * MAIN_CU_FIELDS;
#ifdef EVC_MAIN_TRACE
    evc_trace_bins = 0;
    fprintf(stderr, "[cu] %d (%d,%d %dx%d) pm=%d ipm=%d tree=%d r=%u v=%u\n",
            d->n_cus, x, y, 1 << log2_cuw, 1 << log2_cuh, pred_mode, ipm,
            tree_type, d->sbac.range, d->sbac.value);
#endif
    rec[M_X] = x; rec[M_Y] = y;
    rec[M_LOG2W] = log2_cuw; rec[M_LOG2H] = log2_cuh;
    rec[M_PRED_MODE] = pred_mode;
    rec[M_IPM] = ipm;
    rec[M_IPM_C] = ipm_c < 0 ? ipm : ipm_c;
    rec[M_QP] = qp; rec[M_QP_U] = qp_u; rec[M_QP_V] = qp_v;
    rec[M_CBF_Y] = cbf[0]; rec[M_CBF_U] = cbf[1]; rec[M_CBF_V] = cbf[2];
    rec[M_REFI0] = refi0; rec[M_REFI1] = refi1;
    rec[M_MVP0] = mvp_idx0; rec[M_MVP1] = mvp_idx1;
    rec[M_MVD0X] = mvd[0][0]; rec[M_MVD0Y] = mvd[0][1];
    rec[M_MVD1X] = mvd[1][0]; rec[M_MVD1Y] = mvd[1][1];
    rec[M_INTER_DIR] = inter_dir;
    rec[M_TREE] = tree_type;
    rec[M_MVR_IDX] = mvr_idx;
    rec[M_BI_IDX] = bi_idx;
    rec[M_MMVD_FLAG] = mmvd_flag;
    rec[M_MMVD_IDX] = mmvd_idx;
    rec[M_ATS_CU] = ats.ats_cu;
    rec[M_ATS_MODE] = ats.ats_mode;
    rec[M_ATS_INTER] = ats.ats_inter;
    rec[M_AFF_FLAG] = aff_flag;
    for (int l = 0; l < 2; l++)
        for (int v = 0; v < 3; v++) {
            rec[M_AFF_MVD + (l * 3 + v) * 2] = aff_mvd[l][v][0];
            rec[M_AFF_MVD + (l * 3 + v) * 2 + 1] = aff_mvd[l][v][1];
        }
    d->n_cus++;

    /* chroma CU-boundary edges: units that carry chroma (tree != TREE_L) */
    if (tree_type != TREE_L) {
        for (int i = 0; i < scuw; i++)
            d->edge_hor_c[y_scu * W + x_scu + i] = 1;
        for (int j = 0; j < scuh; j++)
            d->edge_ver_c[(y_scu + j) * W + x_scu] = 1;
    }
    if (tree_type == TREE_C) return;   /* luma maps stay untouched */

    int is_intra = pred_mode == MODE_INTRA;
    int is_skip = pred_mode == MODE_SKIP;
    for (int j = 0; j < scuh; j++) {
        int row = (y_scu + j) * W + x_scu;
        for (int i = 0; i < scuw; i++) {
            d->map_if[row + i] = (uint8_t)is_intra;
            d->map_qp[row + i] = qp;
            d->map_skip[row + i] = (uint8_t)is_skip;
            d->map_ats[row + i] = (uint8_t)ats.ats_inter;
            if (is_intra) d->map_ipm[row + i] = (int8_t)ipm;
            d->cod_eco[row + i] = 1;
            d->map_logw[row + i] = (uint8_t)log2_cuw;
            d->map_logh[row + i] = (uint8_t)log2_cuh;
            d->map_aff_eco[row + i] = (uint8_t)aff_flag;
            d->map_ibc_eco[row + i] =
                (uint8_t)(pred_mode == MODE_IBC ? 1 : 0);
        }
    }
    /* cbf-luma map: ATS-inter marks the coded sub-TU only
       (ref: src_main/xevdm_util.c xevdm_set_cu_cbf_flags) */
    if (ats.ats_inter) {
        for (int j = 0; j < scuh; j++)
            for (int i = 0; i < scuw; i++)
                d->map_cbfl[(y_scu + j) * W + x_scu + i] = 0;
        if (cbf[0]) {
            int ltw, lth, xo, yo;
            ats_inter_tu_size(ats.ats_inter, log2_cuw, log2_cuh, &ltw, &lth);
            ats_inter_tu_offset(ats.ats_inter, log2_cuw, log2_cuh, &xo, &yo);
            for (int j = yo >> 2; j < (yo + (1 << lth)) >> 2; j++)
                for (int i = xo >> 2; i < (xo + (1 << ltw)) >> 2; i++)
                    d->map_cbfl[(y_scu + j) * W + x_scu + i] = 1;
        }
    } else {
        for (int j = 0; j < scuh; j++)
            for (int i = 0; i < scuw; i++)
                d->map_cbfl[(y_scu + j) * W + x_scu + i] =
                    (uint8_t)(cbf[0] ? 1 : 0);
    }
    for (int i = 0; i < scuw; i++)
        d->edge_hor[y_scu * W + x_scu + i] = 1;
    for (int j = 0; j < scuh; j++)
        d->edge_ver[(y_scu + j) * W + x_scu] = 1;
}

/* ---------------- split + SUCO syntax (frame.py:617-688) ------------ */
static int read_split_b(MDec *d, int cuw, int cuh) {
    /* Baseline-style split_cu_flag (ref: src_base/xevd_eco.c:985-998) */
    if (cuw < 8 && cuh < 8) return NO_SPLIT;
    return sbac_bin(&d->sbac, MCTX_SPLIT_CU_FLAG) ? SPLIT_QUAD : NO_SPLIT;
}

static int read_split_mode_main(MDec *d, int x0, int y0, int log2_cuw,
                                int log2_cuh, int mode_cons) {
    /* BTT split syntax (ref: src_main/xevdm_eco.c:1173-1298) */
    Sbac *s = &d->sbac;
    int cuw = 1 << log2_cuw, cuh = 1 << log2_cuh;
    if (cuw < 8 && cuh < 8) return NO_SPLIT;
    if (!d->p[P_BTT]) return read_split_b(d, cuw, cuh);

    int allow[6];
    check_split_mode(d, log2_cuw, log2_cuh, 0, 0, 0, x0, y0, mode_cons,
                     allow);
    if (!(allow[SPLIT_BI_VER] || allow[SPLIT_BI_HOR]
          || allow[SPLIT_TRI_VER] || allow[SPLIT_TRI_HOR]))
        return NO_SPLIT;

    int ctx = 0;
    if (d->cm_init) {
        int x_scu = x0 >> 2, y_scu = y0 >> 2;
        int scuw = cuw >> 2;
        int W = d->w_scu;
        int smaller = 0;
        if (y_scu > 0) {          /* up: no cod check in entropy order */
            if ((1 << d->map_logw[(y_scu - 1) * W + x_scu]) < cuw)
                smaller++;
        }
        if (x_scu > 0 && d->cod_eco[y_scu * W + x_scu - 1]) {
            if ((1 << d->map_logh[y_scu * W + x_scu - 1]) < cuh)
                smaller++;
        }
        if (x_scu + scuw < W && d->cod_eco[y_scu * W + x_scu + scuw]) {
            if ((1 << d->map_logh[y_scu * W + x_scu + scuw]) < cuh)
                smaller++;
        }
        if (smaller > 2) smaller = 2;
        ctx = smaller + 3 * split_flag_ctx[log2_cuw - 2][log2_cuh - 2];
    }
    if (!sbac_bin(s, MCTX_BTT_SPLIT_FLAG + ctx)) return NO_SPLIT;
    int ctx_dir = d->cm_init ? (log2_cuw - log2_cuh + 2) : 0;
    int split_dir;
    if ((allow[SPLIT_BI_VER] || allow[SPLIT_TRI_VER])
        && (allow[SPLIT_BI_HOR] || allow[SPLIT_TRI_HOR]))
        split_dir = (int)sbac_bin(s, MCTX_BTT_SPLIT_DIR + ctx_dir);
    else
        split_dir = (allow[SPLIT_BI_VER] || allow[SPLIT_TRI_VER]) ? 1 : 0;
    int split_typ;
    if ((split_dir && allow[SPLIT_BI_VER] && allow[SPLIT_TRI_VER])
        || (!split_dir && allow[SPLIT_BI_HOR] && allow[SPLIT_TRI_HOR]))
        split_typ = (int)sbac_bin(s, MCTX_BTT_SPLIT_TYPE);
    else
        split_typ = ((split_dir && allow[SPLIT_TRI_VER])
                     || (!split_dir && allow[SPLIT_TRI_HOR])) ? 1 : 0;
    if (split_typ == 0)
        return split_dir ? SPLIT_BI_VER : SPLIT_BI_HOR;
    return split_dir ? SPLIT_TRI_VER : SPLIT_TRI_HOR;
}

static int read_suco_flag(MDec *d, int cuw, int cuh, int split_mode,
                          int boundary, int parent_suco) {
    /* (ref: src_main/xevdm_eco.c:1300-1334) */
    if (!d->p[P_SUCO]) return 0;
    if (!check_suco_cond(d, cuw, cuh, split_mode, boundary))
        return parent_suco;
    int ctx = 0;
    if (d->cm_init) {
        int mx = cuw > cuh ? cuw : cuh;
        ctx = tbl_log2(mx) - 2;
        ctx = (cuw == cuh) ? ctx * 2 : ctx * 2 + 1;
    }
    return (int)sbac_bin(&d->sbac, MCTX_SUCO_FLAG + ctx);
}

/* ---------------- tree recursion (frame.py:542-615) ----------------- */
static void decode_tree_main(MDec *d, int x0, int y0, int log2_cuw,
                             int log2_cuh, int parent_suco, int mode_cons) {
    /* (ref: src_main/xevdm.c:1640-1850 entropy tree) */
    if (d->err) return;
    int cuw = 1 << log2_cuw, cuh = 1 << log2_cuh;
    int inside = (x0 + cuw <= d->w) && (y0 + cuh <= d->h);
    int split;

    if (cuw > d->min_cuwh || cuh > d->min_cuwh) {
        if (inside) {
            split = read_split_mode_main(d, x0, y0, log2_cuw, log2_cuh,
                                         mode_cons);
        } else {
            int boundary_b = (y0 + cuh > d->h) && !(x0 + cuw > d->w);
            int boundary_r = (x0 + cuw > d->w) && !(y0 + cuh > d->h);
            if (d->p[P_BTT]) {
                int allow[6];
                check_split_mode(d, log2_cuw, log2_cuh, 1, boundary_b,
                                 boundary_r, x0, y0, mode_cons, allow);
                if (allow[SPLIT_BI_VER]) split = SPLIT_BI_VER;
                else if (allow[SPLIT_BI_HOR]) split = SPLIT_BI_HOR;
                else { d->err = -3; return; }
            } else {
                split = read_split_b(d, cuw, cuh);
            }
        }
    } else {
        split = NO_SPLIT;
    }

    int bound = !inside;
    int suco_flag = read_suco_flag(d, cuw, cuh, split, bound, parent_suco);

    if (split != NO_SPLIT) {
        int mode_cons_child = mode_cons;
        int mode_changed = 0;
        if (d->p[P_BTT] && d->admvp) {
            mode_changed = (mode_cons == MC_ALL && d->p[P_CFI] != 0
                            && !chroma_split_allowed(cuw, cuh, split));
            if (mode_changed) {
                if (d->slice_type == SLICE_I
                    || mode_cons_by_split(split, cuw, cuh) == MC_ONLY_INTRA
                    || d->p[P_CFI] != 1) {
                    mode_cons_child = MC_ONLY_INTRA;
                } else {
                    /* mode_cons ctx is always 0 (neighbor info never
                       filled in the reference, xevdm_util.c:1764-1782) */
                    mode_cons_child = sbac_bin(&d->sbac, MCTX_MODE_CONS)
                                      ? MC_ONLY_INTRA : MC_ONLY_INTER;
                }
            }
        }
        int parts[4][4];
        int n = part_structure(split, x0, y0, log2_cuw, log2_cuh, parts);
        int order[4];
        suco_order(is_vertical_split(split) ? suco_flag : 0, split, order);
        for (int k = 0; k < n; k++) {
            int pn = order[k];
            int xs = parts[pn][0], ys = parts[pn][1];
            if (xs < d->w && ys < d->h)
                decode_tree_main(d, xs, ys, parts[pn][2], parts[pn][3],
                                 suco_flag, mode_cons_child);
        }
        if (mode_changed && mode_cons_child == MC_ONLY_INTRA) {
            /* local dual tree: chroma of the node as one TREE_C unit
               (ref: src_main/xevdm.c:1833-1838) */
            decode_cu(d, x0, y0, log2_cuw, log2_cuh, TREE_C, MC_ONLY_INTRA);
        }
    } else {
        int tree_type = mode_cons == MC_ONLY_INTRA ? TREE_L : TREE_LC;
        if (d->slice_type == SLICE_I
            || (d->admvp && log2_cuw == 2 && log2_cuh == 2))
            mode_cons = MC_ONLY_INTRA;
        decode_cu(d, x0, y0, log2_cuw, log2_cuh, tree_type, mode_cons);
    }
}

/* ---------------- entry point ---------------- */
/* returns n_cus on success, negative on error */
int evc_main_decode_slice(
    const uint8_t *payload, int payload_size,
    const int32_t *params,
    const int32_t *chroma_qp_tbl_u, const int32_t *chroma_qp_tbl_v,
    int16_t *coef_y, int16_t *coef_u, int16_t *coef_v,
    int32_t *cu_out,
    uint8_t *map_if, int32_t *map_qp, uint8_t *map_cbfl, int8_t *map_ipm,
    uint8_t *map_skip, uint8_t *map_ats,
    uint8_t *edge_hor, uint8_t *edge_ver,
    uint8_t *edge_hor_c, uint8_t *edge_ver_c,
    uint8_t *alf_ctu_on)
{
    m_scan_init();
    MDec d;
    memset(&d, 0, sizeof(d));
    d.p = params;
    d.w = params[P_W]; d.h = params[P_H];
    d.log2_ctu = params[P_LOG2_CTU];
    d.min_cuwh = params[P_MIN_CUWH];
    int ctu = 1 << d.log2_ctu;
    d.w_lcu = (d.w + ctu - 1) / ctu;
    d.h_lcu = (d.h + ctu - 1) / ctu;
    d.w_pad = d.w_lcu * ctu; d.h_pad = d.h_lcu * ctu;
    d.w_scu = (d.w + 3) >> 2; d.h_scu = (d.h + 3) >> 2;
    d.slice_type = params[P_SLICE_TYPE];
    d.qp = params[P_QP];
    d.cw_shift = params[P_CW_SHIFT];
    d.ch_shift = params[P_CH_SHIFT];
    d.chroma_stride = d.w_pad >> d.cw_shift;
    d.cm_init = params[P_CM_INIT];
    d.admvp = params[P_ADMVP];
    d.eipd = params[P_EIPD];
    d.adcc = params[P_ADCC];
    d.ats = params[P_ATS];
    d.affine = params[P_AFFINE];
    d.chroma_qp_tbl_u = chroma_qp_tbl_u;
    d.chroma_qp_tbl_v = chroma_qp_tbl_v;
    d.coef_y = coef_y; d.coef_u = coef_u; d.coef_v = coef_v;
    d.cu_out = cu_out;
    d.map_if = map_if; d.map_qp = map_qp; d.map_cbfl = map_cbfl;
    d.map_ipm = map_ipm; d.map_skip = map_skip; d.map_ats = map_ats;
    d.edge_hor = edge_hor; d.edge_ver = edge_ver;
    d.edge_hor_c = edge_hor_c; d.edge_ver_c = edge_ver_c;
    d.alf_ctu_on = alf_ctu_on;
    d.qp_prev_eco = d.qp;
    d.err = 0;

    size_t n_scu = (size_t)d.w_scu * d.h_scu;
    uint8_t *scratch = (uint8_t *)malloc(n_scu * 5);
    if (!scratch) return -4;
    d.cod_eco = scratch;
    d.map_logw = scratch + n_scu;
    d.map_logh = scratch + 2 * n_scu;
    d.map_aff_eco = scratch + 3 * n_scu;
    d.map_ibc_eco = scratch + 4 * n_scu;
    memset(scratch, 0, n_scu * 5);
    memset(map_ipm, -1, n_scu);

    bsr_init(&d.bs, payload, payload_size);
    sbac_reset(&d.sbac, &d.bs, d.slice_type, d.qp, d.cm_init);

    int n_ctu = d.w_lcu * d.h_lcu;
    for (int c = 0; c < n_ctu; c++) {
        int x0 = (c % d.w_lcu) << d.log2_ctu;
        int y0 = (c / d.w_lcu) << d.log2_ctu;
        alf_ctu_on[c] = 1;
        if (params[P_ALF_CTB_BINS])
            alf_ctu_on[c] = (uint8_t)sbac_bin(&d.sbac, MCTX_ALF_CTB_FLAG);
        decode_tree_main(&d, x0, y0, d.log2_ctu, d.log2_ctu, 0, MC_ALL);
        if (d.err) { free(scratch); return d.err; }
    }
    free(scratch);
    if (sbac_trm(&d.sbac) != 1) return -1;
    while (!bsr_at_end(&d.bs)) {
        uint32_t zw = bsr_read(&d.bs, 16);
        if (zw != 0 && zw != 0xFFFFFFFFu) return -2;
    }
    return d.n_cus;
}
