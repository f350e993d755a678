/* Native host entropy engine for xevd_tpu: EVC Baseline slice decode.
 *
 * Mirrors the Python entropy pass (xevd_tpu/frame.py) with identical
 * semantics — bit reader (ref: src_base/xevd_bsr.c), SBAC engine
 * (ref: src_base/xevd_eco.c:35-164) and Baseline CU-tree syntax
 * (ref: src_base/xevd_eco.c:1048-1176) — emitting the per-frame tensor
 * batch consumed by the device pipeline.  Pure C99, no dependencies;
 * called from Python via ctypes.
 */
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define PROB_INIT 512
#define SLICE_B 0
#define SLICE_P 1
#define SLICE_I 2
#define MODE_INTRA 0
#define MODE_INTER 1
#define MODE_SKIP 2
#define PRED_L0 0
#define PRED_L1 1
#define PRED_BI 2
#define PRED_DIR 4
#define REFI_INVALID (-1)

/* ---------------- bit reader ---------------- */
typedef struct {
    const uint8_t *buf;
    int size;
    int cur;
    uint32_t code;
    int leftbits;
} Bsr;

static void bsr_init(Bsr *bs, const uint8_t *buf, int size) {
    bs->buf = buf; bs->size = size; bs->cur = 0; bs->code = 0; bs->leftbits = 0;
}

static int bsr_flush(Bsr *bs) {
    int nbytes = 4;
    int remained = bs->size - bs->cur;
    if (nbytes > remained) nbytes = remained;
    if (nbytes <= 0) { bs->code = 0; bs->leftbits = 0; return 0; }
    bs->leftbits = nbytes << 3;
    uint32_t code = 0;
    int shift = 24;
    for (int i = 0; i < nbytes; i++) { code |= (uint32_t)bs->buf[bs->cur + i] << shift; shift -= 8; }
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
static int bsr_at_end(const Bsr *bs) { return bs->cur >= bs->size && bs->leftbits == 0; }

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

/* ---------------- SBAC ---------------- */
enum {
    CTX_SKIP = 0,            /* 2 */
    CTX_DIRECT = 2,          /* 1 */
    CTX_MERGE_MODE = 3,      /* 1 */
    CTX_INTER_DIR = 4,       /* 2 */
    CTX_INTRA_DIR = 6,       /* 2 */
    CTX_MPM_FLAG = 8,        /* 1 */
    CTX_MPM_IDX = 9,         /* 1 */
    CTX_CHROMA_MODE = 10,    /* 1 */
    CTX_PRED_MODE = 11,      /* 3 */
    CTX_REFI = 14,           /* 2 */
    CTX_MERGE_IDX = 16,      /* 5 */
    CTX_MVP_IDX = 21,        /* 3 */
    CTX_BI_IDX = 24,         /* 2 */
    CTX_MVD = 26,            /* 1 */
    CTX_CBF_ALL = 27,        /* 1 */
    CTX_CBF_LUMA = 28,       /* 1 */
    CTX_CBF_CB = 29,         /* 1 */
    CTX_CBF_CR = 30,         /* 1 */
    CTX_RUN = 31,            /* 24 */
    CTX_LAST = 55,           /* 2 */
    CTX_LEVEL = 57,          /* 24 */
    CTX_SPLIT = 81,          /* 1 */
    CTX_DQP = 82,            /* 1 */
    NUM_CTX = 83
};

typedef struct {
    uint32_t range, value;
    uint16_t ctx[NUM_CTX];
    Bsr *bs;
} Sbac;

static void sbac_reset(Sbac *s, Bsr *bs) {
    s->bs = bs;
    s->range = 16384;
    uint32_t v = 0;
    for (int i = 0; i < 14; i++) v = ((v << 1) | bsr_read1(bs)) & 0xFFFF;
    s->value = v;
    for (int i = 0; i < NUM_CTX; i++) s->ctx[i] = PROB_INIT;
}

static uint32_t sbac_bin(Sbac *s, int i) {
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

/* ---------------- tables ---------------- */
static const uint8_t mpm_tbl[6][6][5] = {
 {{0,2,3,1,4},{0,2,1,3,4},{0,2,1,3,4},{1,2,0,3,4},{0,2,1,3,4},{0,1,2,3,4}},
 {{1,0,2,3,4},{0,1,2,3,4},{0,1,2,3,4},{1,2,0,3,4},{0,1,3,2,4},{0,2,1,4,3}},
 {{1,0,2,3,4},{1,0,2,3,4},{1,0,2,3,4},{2,0,1,3,4},{1,0,3,2,4},{0,1,2,4,3}},
 {{1,0,2,3,4},{0,2,1,3,4},{1,0,2,3,4},{1,2,0,3,4},{0,1,2,3,4},{0,2,1,4,3}},
 {{0,1,2,3,4},{0,3,2,1,4},{1,0,2,3,4},{1,2,0,3,4},{1,2,3,0,4},{0,2,1,4,3}},
 {{0,1,2,3,4},{0,1,2,4,3},{0,1,2,4,3},{0,2,1,4,3},{0,1,2,3,4},{0,1,2,4,3}},
};

static uint16_t scan_tbl[7][7][64 * 64];
static int scan_init_done = 0;

static void init_scan(uint16_t *scan, int sx, int sy) {
    int pos = 0;
    scan[pos++] = 0;
    for (int l = 1; l < sx + sy - 1; l++) {
        int x, y;
        if (l & 1) {
            x = l < sx - 1 ? l : sx - 1;
            y = l - x;
            while (x >= 0 && y < sy) { scan[pos++] = (uint16_t)(y * sx + x); x--; y++; }
        } else {
            y = l < sy - 1 ? l : sy - 1;
            x = l - y;
            while (y >= 0 && x < sx) { scan[pos++] = (uint16_t)(y * sx + x); x++; y--; }
        }
    }
}

static void scan_tables_init(void) {
    if (scan_init_done) return;
    for (int ly = 1; ly <= 6; ly++)
        for (int lx = 1; lx <= 6; lx++)
            init_scan(scan_tbl[lx][ly], 1 << lx, 1 << ly);
    scan_init_done = 1;
}

/* ---------------- decoder state ---------------- */
typedef struct {
    /* config */
    int w, h, w_pad, h_pad, w_scu, h_scu, w_lcu, h_lcu;
    int slice_type, qp, qp_u_offset, qp_v_offset;
    int cu_qp_delta_enabled, chroma_format_idc;
    int num_refp0, num_refp1;
    int bit_depth_chroma_m8;
    const int32_t *chroma_qp_tbl_u;   /* [MAX_QP_TABLE_SIZE_EXT] */
    const int32_t *chroma_qp_tbl_v;
    /* outputs */
    int16_t *coef_y;   /* [h_pad][w_pad] */
    int16_t *coef_u;   /* [h_pad/2][w_pad/2] */
    int16_t *coef_v;
    int32_t *cu_out;   /* [max_cus][CU_FIELDS] */
    uint8_t *map_if;
    int32_t *map_qp;
    uint8_t *map_cbfl;
    int8_t  *map_ipm;
    uint8_t *map_skip;
    uint8_t *edge_hor;
    uint8_t *edge_ver;
    uint8_t *cod_eco;
    /* derive-pass state (host motion reconstruction, mirrors derive.py /
       ref: src_base/xevd.c:477-565, xevd_util.c:469-566,632-745) */
    int derive_on;
    int constrained_ipred;
    int poc;
    int ref0_l0_poc;        /* refp[0][0].poc */
    const int16_t *ref_mv[2];  /* refp[0][l].map_mv base, or NULL */
    int r1_poc, r1_list_poc0, have_r1;
    int16_t *map_mv;        /* out: [h_scu][w_scu][2][2] */
    int8_t  *map_refi;      /* out: [h_scu][w_scu][2] */
    int n_cus;
    int qp_prev_eco;
    Sbac sbac;
    Bsr bs;
} Dec;

/* per-CU output record layout (int32), must match frame.py consumer */
enum {
    F_X = 0, F_Y, F_LOG2, F_PRED_MODE, F_IPM, F_QP, F_QP_U, F_QP_V,
    F_CBF_Y, F_CBF_U, F_CBF_V, F_REFI0, F_REFI1, F_MVP0, F_MVP1,
    F_MVD0X, F_MVD0Y, F_MVD1X, F_MVD1Y, F_INTER_DIR,
    /* derive-pass outputs (final motion + intra availability) */
    F_MV0X, F_MV0Y, F_MV1X, F_MV1Y, F_RREFI0, F_RREFI1,
    F_NBR_UP, F_NBR_LEFT, F_NBR_CORNER, CU_FIELDS
};

static int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }

static void chroma_qps(Dec *d, int qp, int *qp_u, int *qp_v) {
    int off = 6 * d->bit_depth_chroma_m8;
    int qi_cb = clip3(-off, 57, qp + d->qp_u_offset);
    int qi_cr = clip3(-off, 57, qp + d->qp_v_offset);
    *qp_u = d->chroma_qp_tbl_u[qi_cb + off] + off;
    *qp_v = d->chroma_qp_tbl_v[qi_cr + off] + off;
}

static uint32_t read_abs_mvd(Dec *d) {
    Sbac *s = &d->sbac;
    uint32_t code = sbac_bin(s, CTX_MVD);
    if (code) return 0;
    int len = 0;
    while (!(code & 1)) {
        code = (len == 0) ? sbac_bin(s, CTX_MVD) : sbac_ep(s);
        len++;
    }
    uint32_t val = (1u << len) - 1;
    while (len) { len--; val += sbac_ep(s) << len; }
    return val;
}

static int read_refi(Dec *d, int num_refp) {
    Sbac *s = &d->sbac;
    int ref = 0;
    if (num_refp > 1) {
        if (sbac_bin(s, CTX_REFI)) {
            ref++;
            if (num_refp > 2 && sbac_bin(s, CTX_REFI + 1)) {
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

static void read_coef_block(Dec *d, int16_t *plane, int stride, int bx,
                            int by, int log2_w, int log2_h, int ch_type) {
    Sbac *s = &d->sbac;
    const uint16_t *scanp = scan_tbl[log2_w][log2_h];
    int num_coeff = 1 << (log2_w + log2_h);
    int t0 = ch_type == 0 ? 0 : 2;
    int ctx_last = ch_type == 0 ? 0 : 1;
    int w = 1 << log2_w;
    int pos = 0;
    for (;;) {
        int run = (int)sbac_unary(s, CTX_RUN + t0, 2);
        pos += run;
        int level = (int)sbac_unary(s, CTX_LEVEL + t0, 2) + 1;
        int sign = (int)sbac_ep(s);
        int p = scanp[pos];
        plane[(by + p / w) * stride + bx + (p % w)] =
            (int16_t)(sign ? -level : level);
        if (pos >= num_coeff - 1) break;
        pos++;
        if (sbac_bin(s, CTX_LAST + ctx_last)) break;
    }
}

static int decode_coef(Dec *d, int x, int y, int log2, int pred_mode,
                       int inter_dir, int *cbf, int *qp_out) {
    Sbac *s = &d->sbac;
    int b_no_cbf = 0; /* Baseline never sets MODE_DIR
                          (ref: src_base/xevd_eco.c:611) */
    (void)inter_dir;
    cbf[0] = cbf[1] = cbf[2] = 0;
    if (pred_mode != MODE_INTRA) {
        if (!b_no_cbf) {
            if (sbac_bin(s, CTX_CBF_ALL) == 0) {
                *qp_out = d->qp_prev_eco;
                return 0;
            }
        }
        if (d->chroma_format_idc) {
            cbf[1] = (int)sbac_bin(s, CTX_CBF_CB);
            cbf[2] = (int)sbac_bin(s, CTX_CBF_CR);
        }
        if (cbf[1] + cbf[2] == 0) cbf[0] = 1;
        else cbf[0] = (int)sbac_bin(s, CTX_CBF_LUMA);
    } else {
        if (d->chroma_format_idc) {
            cbf[1] = (int)sbac_bin(s, CTX_CBF_CB);
            cbf[2] = (int)sbac_bin(s, CTX_CBF_CR);
        }
        cbf[0] = (int)sbac_bin(s, CTX_CBF_LUMA);
    }
    int qp;
    if (d->cu_qp_delta_enabled && (cbf[0] || cbf[1] || cbf[2])) {
        int dqp = (int)sbac_unary(s, CTX_DQP, 1);
        if (dqp > 0 && sbac_ep(s)) dqp = -dqp;
        qp = (d->qp_prev_eco + dqp + 52) % 52;
        d->qp_prev_eco = qp;
    } else {
        qp = d->qp_prev_eco;
    }
    if (cbf[0])
        read_coef_block(d, d->coef_y, d->w_pad, x, y, log2, log2, 0);
    if (cbf[1])
        read_coef_block(d, d->coef_u, d->w_pad >> 1, x >> 1, y >> 1,
                        log2 - 1, log2 - 1, 1);
    if (cbf[2])
        read_coef_block(d, d->coef_v, d->w_pad >> 1, x >> 1, y >> 1,
                        log2 - 1, log2 - 1, 1);
    *qp_out = qp;
    return 0;
}

static int read_intra_dir(Dec *d, int x_scu, int y_scu) {
    int ipm_l = 0, ipm_u = 0;
    int scup = y_scu * d->w_scu + x_scu;
    if (x_scu > 0 && d->map_if[scup - 1] && d->cod_eco[scup - 1])
        ipm_l = d->map_ipm[scup - 1] + 1;
    if (y_scu > 0 && d->map_if[scup - d->w_scu] && d->cod_eco[scup - d->w_scu])
        ipm_u = d->map_ipm[scup - d->w_scu] + 1;
    const uint8_t *mpm = mpm_tbl[ipm_l][ipm_u];
    uint32_t t0 = sbac_unary(&d->sbac, CTX_INTRA_DIR, 2);
    int ipm = 0;
    for (int i = 0; i < 5; i++) if (t0 == mpm[i]) ipm = i;
    return ipm;
}

/* ------------------------------------------------------------------ */
/* derive pass: baseline motion + intra availability, in decode order
   (mirrors derive.py; ref: src_base/xevd.c:477-565)                   */
/* ------------------------------------------------------------------ */
#define AVAIL_UP 1
#define AVAIL_LE 2
#define AVAIL_UP_RI 4
#define PRED_DIR_C PRED_DIR

static int s16wrap(int v) {
    v &= 0xFFFF;
    return v >= 0x8000 ? v - 0x10000 : v;
}

static int div_trunc(long long a, long long b) {
    long long q = (a < 0 ? -a : a) / (b < 0 ? -b : b);
    return (int)(((a < 0) != (b < 0)) ? -q : q);
}

static void mvp_candidates(Dec *d, int lidx, int x_scu, int y_scu, int scuw,
                           int avail, int mvp[4][2]) {
    /* (ref: src_base/xevd_util.c:469-515) */
    for (int k = 0; k < 4; k++) mvp[k][0] = mvp[k][1] = 1;
    const int16_t *mm = d->map_mv;
    int W = d->w_scu;
    if (avail & AVAIL_LE) {
        const int16_t *p = mm + ((y_scu * W + x_scu - 1) * 2 + lidx) * 2;
        mvp[0][0] = p[0]; mvp[0][1] = p[1];
    }
    if (avail & AVAIL_UP) {
        const int16_t *p = mm + (((y_scu - 1) * W + x_scu) * 2 + lidx) * 2;
        mvp[1][0] = p[0]; mvp[1][1] = p[1];
    }
    if (avail & AVAIL_UP_RI) {
        const int16_t *p =
            mm + (((y_scu - 1) * W + x_scu + scuw) * 2 + lidx) * 2;
        mvp[2][0] = p[0]; mvp[2][1] = p[1];
    }
    if (d->ref_mv[lidx]) {    /* temporal: refp[0][lidx].map_mv[y][x][0] */
        const int16_t *p =
            d->ref_mv[lidx] + ((y_scu * W + x_scu) * 2 + 0) * 2;
        mvp[3][0] = p[0]; mvp[3][1] = p[1];
    } else {
        mvp[3][0] = mvp[3][1] = 0;
    }
}

static void derive_cu(Dec *d, int x, int y, int log2, int pred_mode,
                      const int refi_p[2], const int mvp_idx[2],
                      int mvd[2][2], int inter_dir, int32_t *rec) {
    int x_scu = x >> 2, y_scu = y >> 2;
    int scuw = 1 << (log2 - 2), scuh = scuw;
    int W = d->w_scu, H = d->h_scu;
    int mv[2][2] = {{0, 0}, {0, 0}};
    int refi[2] = {REFI_INVALID, REFI_INVALID};
    uint32_t up_mask = 0, left_mask = 0;
    int corner = 0;

    if (pred_mode == MODE_INTRA) {
        /* (ref: src_base/xevd_ipred.c:33-93, xevd_util.c:689-745) */
        int n_units = scuw + scuh;
        if (y_scu > 0)
            for (int u = 0; u < n_units; u++) {
                int xs = x_scu + u;
                if (xs < W && d->cod_eco[(y_scu - 1) * W + xs] &&
                    (!d->constrained_ipred || d->map_if[(y_scu - 1) * W + xs]))
                    up_mask |= 1u << u;
            }
        if (x_scu > 0)
            for (int u = 0; u < n_units; u++) {
                int ys = y_scu + u;
                if (ys < H && d->cod_eco[ys * W + x_scu - 1] &&
                    (!d->constrained_ipred || d->map_if[ys * W + x_scu - 1]))
                    left_mask |= 1u << u;
            }
        if (x_scu > 0 && y_scu > 0 &&
            d->cod_eco[(y_scu - 1) * W + x_scu - 1] &&
            (!d->constrained_ipred || d->map_if[(y_scu - 1) * W + x_scu - 1]))
            corner = 1;
    } else {
        /* availability (ref: src_base/xevd_util.c:632-687) */
        int avail = 0;
        if (x_scu > 0 && !d->map_if[y_scu * W + x_scu - 1] &&
            d->cod_eco[y_scu * W + x_scu - 1])
            avail |= AVAIL_LE;
        if (y_scu > 0) {
            if (!d->map_if[(y_scu - 1) * W + x_scu]) avail |= AVAIL_UP;
            if (x_scu + scuw < W &&
                d->cod_eco[(y_scu - 1) * W + x_scu + scuw] &&
                !d->map_if[(y_scu - 1) * W + x_scu + scuw])
                avail |= AVAIL_UP_RI;
        }
        int mvp[4][2];
        if (pred_mode == MODE_SKIP) {
            int nl = d->slice_type == SLICE_B ? 2 : 1;
            for (int l = 0; l < nl; l++) {
                mvp_candidates(d, l, x_scu, y_scu, scuw, avail, mvp);
                int mi = mvp_idx[l];
                mv[l][0] = mvp[mi][0]; mv[l][1] = mvp[mi][1];
                refi[l] = 0;
            }
        } else if (inter_dir == PRED_DIR_C) {
            /* temporal direct (ref: src_base/xevd_util.c:540-566) */
            int yc = y_scu + scuh - 1, xc = x_scu + scuw - 1;
            const int16_t *p =
                d->ref_mv[1] + ((yc * W + xc) * 2 + 0) * 2;
            int dpoc_co = d->r1_poc - d->r1_list_poc0;
            int dpoc_l0 = d->poc - d->ref0_l0_poc;
            int dpoc_l1 = d->r1_poc - d->poc;
            if (dpoc_co == 0) {
                mv[0][0] = mv[0][1] = mv[1][0] = mv[1][1] = 0;
            } else {
                mv[0][0] = div_trunc((long long)dpoc_l0 * p[0], dpoc_co);
                mv[0][1] = div_trunc((long long)dpoc_l0 * p[1], dpoc_co);
                mv[1][0] = div_trunc(-(long long)dpoc_l1 * p[0], dpoc_co);
                mv[1][1] = div_trunc(-(long long)dpoc_l1 * p[1], dpoc_co);
            }
            refi[0] = refi[1] = 0;
        } else {
            for (int l = 0; l < 2; l++) {
                if (((inter_dir + 1) >> l) & 1) {
                    mvp_candidates(d, l, x_scu, y_scu, scuw, avail, mvp);
                    int mi = mvp_idx[l];
                    mv[l][0] = s16wrap(mvp[mi][0] + mvd[l][0]);
                    mv[l][1] = s16wrap(mvp[mi][1] + mvd[l][1]);
                    refi[l] = refi_p[l];
                }
            }
        }
    }

    rec[F_MV0X] = mv[0][0]; rec[F_MV0Y] = mv[0][1];
    rec[F_MV1X] = mv[1][0]; rec[F_MV1Y] = mv[1][1];
    rec[F_RREFI0] = refi[0]; rec[F_RREFI1] = refi[1];
    rec[F_NBR_UP] = (int32_t)up_mask;
    rec[F_NBR_LEFT] = (int32_t)left_mask;
    rec[F_NBR_CORNER] = corner;

    for (int j = 0; j < scuh; j++) {
        int row = (y_scu + j) * W + x_scu;
        for (int i = 0; i < scuw; i++) {
            int8_t *rf = d->map_refi + (row + i) * 2;
            int16_t *mm = d->map_mv + (row + i) * 4;
            rf[0] = (int8_t)refi[0]; rf[1] = (int8_t)refi[1];
            mm[0] = (int16_t)mv[0][0]; mm[1] = (int16_t)mv[0][1];
            mm[2] = (int16_t)mv[1][0]; mm[3] = (int16_t)mv[1][1];
        }
    }
}

static void decode_cu(Dec *d, int x, int y, int log2) {
    Sbac *s = &d->sbac;
    int x_scu = x >> 2, y_scu = y >> 2;
    int scuw = 1 << (log2 - 2);
    int pred_mode = MODE_INTRA;
    int mvp_idx0 = 0, mvp_idx1 = 0;
    int mvd[2][2] = {{0, 0}, {0, 0}};
    int refi0 = REFI_INVALID, refi1 = REFI_INVALID;
    int inter_dir = 0, ipm = 0, qp;
    int cbf[3] = {0, 0, 0};

    if (d->slice_type != SLICE_I) {
        if (sbac_bin(s, CTX_SKIP)) pred_mode = MODE_SKIP;
    }

    if (pred_mode == MODE_SKIP) {
        mvp_idx0 = (int)sbac_tu(s, CTX_MVP_IDX, 3, 4);
        if (d->slice_type == SLICE_B)
            mvp_idx1 = (int)sbac_tu(s, CTX_MVP_IDX, 3, 4);
        qp = d->cu_qp_delta_enabled ? d->qp_prev_eco : d->qp;
    } else {
        if (d->slice_type != SLICE_I)
            pred_mode = sbac_bin(s, CTX_PRED_MODE) ? MODE_INTRA : MODE_INTER;
        if (pred_mode == MODE_INTER) {
            if (d->slice_type == SLICE_B) {
                if (sbac_bin(s, CTX_DIRECT)) inter_dir = PRED_DIR;
            }
            if (inter_dir != PRED_DIR) {
                if (d->slice_type == SLICE_B) {
                    if (!sbac_bin(s, CTX_INTER_DIR)) inter_dir = PRED_BI;
                    else inter_dir = sbac_bin(s, CTX_INTER_DIR + 1) ? PRED_L1
                                                                    : PRED_L0;
                } else {
                    inter_dir = PRED_L0;
                }
                for (int lidx = 0; lidx < 2; lidx++) {
                    if (((inter_dir + 1) >> lidx) & 1) {
                        int nr = lidx == 0 ? d->num_refp0 : d->num_refp1;
                        int r = read_refi(d, nr);
                        int mi = (int)sbac_tu(s, CTX_MVP_IDX, 3, 4);
                        if (lidx == 0) { refi0 = r; mvp_idx0 = mi; }
                        else { refi1 = r; mvp_idx1 = mi; }
                        for (int dd = 0; dd < 2; dd++) {
                            int v = (int)read_abs_mvd(d);
                            if (v && sbac_ep(s)) v = -v;
                            mvd[lidx][dd] = v;
                        }
                    }
                }
            }
        } else {
            ipm = read_intra_dir(d, x_scu, y_scu);
        }
        decode_coef(d, x, y, log2, pred_mode, inter_dir, cbf, &qp);
    }

    int qp_u, qp_v;
    chroma_qps(d, qp, &qp_u, &qp_v);

    int32_t *rec = d->cu_out + (int64_t)d->n_cus * CU_FIELDS;
    rec[F_X] = x; rec[F_Y] = y; rec[F_LOG2] = log2;
    rec[F_PRED_MODE] = pred_mode; rec[F_IPM] = ipm;
    rec[F_QP] = qp; rec[F_QP_U] = qp_u; rec[F_QP_V] = qp_v;
    rec[F_CBF_Y] = cbf[0]; rec[F_CBF_U] = cbf[1]; rec[F_CBF_V] = cbf[2];
    rec[F_REFI0] = refi0; rec[F_REFI1] = refi1;
    rec[F_MVP0] = mvp_idx0; rec[F_MVP1] = mvp_idx1;
    rec[F_MVD0X] = mvd[0][0]; rec[F_MVD0Y] = mvd[0][1];
    rec[F_MVD1X] = mvd[1][0]; rec[F_MVD1Y] = mvd[1][1];
    rec[F_INTER_DIR] = inter_dir;
    if (d->derive_on) {
        int refi_p[2] = {refi0, refi1};
        int mvp_i[2] = {mvp_idx0, mvp_idx1};
        derive_cu(d, x, y, log2, pred_mode, refi_p, mvp_i, mvd, inter_dir,
                  rec);
    }
    d->n_cus++;

    int is_intra = pred_mode == MODE_INTRA;
    for (int j = 0; j < scuw; j++) {
        int row = (y_scu + j) * d->w_scu + x_scu;
        for (int i = 0; i < scuw; i++) {
            d->map_if[row + i] = (uint8_t)is_intra;
            d->map_qp[row + i] = qp;
            d->map_cbfl[row + i] = (uint8_t)cbf[0];
            d->map_skip[row + i] = (uint8_t)(pred_mode == MODE_SKIP);
            if (is_intra) d->map_ipm[row + i] = (int8_t)ipm;
            d->cod_eco[row + i] = 1;
        }
    }
    for (int i = 0; i < scuw; i++)
        d->edge_hor[y_scu * d->w_scu + x_scu + i] = 1;
    for (int j = 0; j < scuw; j++)
        d->edge_ver[(y_scu + j) * d->w_scu + x_scu] = 1;
}

static void decode_tree(Dec *d, int x0, int y0, int log2) {
    int cuw = 1 << log2;
    int split = 0;
    if (cuw > 4) {
        /* split_cu_flag (ref: src_base/xevd_eco.c:985-998) */
        split = (int)sbac_bin(&d->sbac, CTX_SPLIT);
    }
    if (split) {
        int half = cuw >> 1;
        const int offs[4][2] = {{0, 0}, {half, 0}, {0, half}, {half, half}};
        for (int k = 0; k < 4; k++) {
            int xs = x0 + offs[k][0], ys = y0 + offs[k][1];
            if (xs < d->w && ys < d->h)
                decode_tree(d, xs, ys, log2 - 1);
        }
    } else {
        decode_cu(d, x0, y0, log2);
    }
}

/* returns n_cus on success, negative on error */
int evc_decode_slice(
    const uint8_t *payload, int payload_size,
    int w, int h, int slice_type, int qp, int qp_u_offset, int qp_v_offset,
    int cu_qp_delta_enabled, int chroma_format_idc, int num_refp0,
    int num_refp1, int bit_depth_chroma_m8,
    const int32_t *chroma_qp_tbl_u, const int32_t *chroma_qp_tbl_v,
    int16_t *coef_y, int16_t *coef_u, int16_t *coef_v,
    int32_t *cu_out,
    uint8_t *map_if, int32_t *map_qp, uint8_t *map_cbfl, int8_t *map_ipm,
    uint8_t *map_skip, uint8_t *edge_hor, uint8_t *edge_ver,
    uint8_t *cod_eco_buf,
    /* derive pass (NULL map_mv_out disables it) */
    int16_t *map_mv_out, int8_t *map_refi_out,
    int constrained_ipred, int poc, int ref0_l0_poc,
    const int16_t *ref_l0_mv, const int16_t *ref_l1_mv,
    int r1_poc, int r1_list_poc0)
{
    scan_tables_init();
    Dec d;
    memset(&d, 0, sizeof(d));
    d.w = w; d.h = h;
    d.w_lcu = (w + 63) / 64; d.h_lcu = (h + 63) / 64;
    d.w_pad = d.w_lcu * 64; d.h_pad = d.h_lcu * 64;
    d.w_scu = (w + 3) >> 2; d.h_scu = (h + 3) >> 2;
    d.slice_type = slice_type; d.qp = qp;
    d.qp_u_offset = qp_u_offset; d.qp_v_offset = qp_v_offset;
    d.cu_qp_delta_enabled = cu_qp_delta_enabled;
    d.chroma_format_idc = chroma_format_idc;
    d.num_refp0 = num_refp0; d.num_refp1 = num_refp1;
    d.bit_depth_chroma_m8 = bit_depth_chroma_m8;
    d.chroma_qp_tbl_u = chroma_qp_tbl_u;
    d.chroma_qp_tbl_v = chroma_qp_tbl_v;
    d.coef_y = coef_y; d.coef_u = coef_u; d.coef_v = coef_v;
    d.cu_out = cu_out;
    d.map_if = map_if; d.map_qp = map_qp; d.map_cbfl = map_cbfl;
    d.map_ipm = map_ipm; d.map_skip = map_skip;
    d.edge_hor = edge_hor; d.edge_ver = edge_ver;
    d.cod_eco = cod_eco_buf;
    d.qp_prev_eco = qp;
    d.derive_on = map_mv_out != NULL;
    d.map_mv = map_mv_out;
    d.map_refi = map_refi_out;
    d.constrained_ipred = constrained_ipred;
    d.poc = poc;
    d.ref0_l0_poc = ref0_l0_poc;
    d.ref_mv[0] = ref_l0_mv;
    d.ref_mv[1] = ref_l1_mv;
    d.r1_poc = r1_poc;
    d.r1_list_poc0 = r1_list_poc0;

    memset(map_ipm, -1, (size_t)d.w_scu * d.h_scu);

    bsr_init(&d.bs, payload, payload_size);
    sbac_reset(&d.sbac, &d.bs);

    int n_ctu = d.w_lcu * d.h_lcu;
    for (int c = 0; c < n_ctu; c++) {
        int x0 = (c % d.w_lcu) << 6;
        int y0 = (c / d.w_lcu) << 6;
        decode_tree(&d, x0, y0, 6);
    }
    if (sbac_trm(&d.sbac) != 1) return -1;
    while (!bsr_at_end(&d.bs)) {
        uint32_t zw = bsr_read(&d.bs, 16);
        if (zw != 0 && zw != 0xFFFFFFFFu) return -2;
    }
    return d.n_cus;
}

/* ------------------------------------------------------------------ */
/* Deblock boundary-strength maps (Baseline filter), the vectorized
 * equivalent of derive._deblock_strengths
 * (ref: src_base/xevd_df.c:34-94,291-545).  Strengths for the edge at
 * each SCU cell: hor (top edge, pair with cell above) and ver (left
 * edge, pair with cell left); 0 = no filtering. */
static int df_table_idx(const uint8_t *map_if, const uint8_t *map_cbfl,
                        const int8_t *map_refi, const int16_t *map_mv,
                        int cur, int nb)
{
    if (map_if[cur] || map_if[nb]) return 0;
    if (map_cbfl[cur] || map_cbfl[nb]) return 1;
    const int8_t *r0 = map_refi + cur * 2, *r1 = map_refi + nb * 2;
    int16_t m0[4], m1[4];
    for (int k = 0; k < 4; k++) { m0[k] = map_mv[cur * 4 + k];
                                  m1[k] = map_mv[nb * 4 + k]; }
    if (r0[0] < 0) { m0[0] = m0[1] = 0; }
    if (r0[1] < 0) { m0[2] = m0[3] = 0; }
    if (r1[0] < 0) { m1[0] = m1[1] = 0; }
    if (r1[1] < 0) { m1[2] = m1[3] = 0; }
    int same = (r0[0] == r1[0]) && (r0[1] == r1[1]);
    int cross = (r0[0] == r1[1]) && (r0[1] == r1[0]);
    if (same) {
        int big = 0;
        for (int k = 0; k < 4; k++)
            if (abs(m0[k] - m1[k]) >= 4) big = 1;
        return big ? 2 : 3;
    }
    if (cross) {
        int big = 0;
        for (int k = 0; k < 4; k++)
            if (abs(m0[k] - m1[k ^ 2]) >= 4) big = 1;
        return big ? 2 : 3;
    }
    return 2;
}

void evc_deblock_strengths(
    int w_scu, int h_scu,
    const uint8_t *map_if, const uint8_t *map_cbfl, const int32_t *map_qp,
    const uint8_t *edge_hor, const uint8_t *edge_ver,
    const int8_t *map_refi, const int16_t *map_mv,
    const int32_t *df_st,               /* [4][52] */
    const int32_t *qp_tab_u, const int32_t *qp_tab_v,
    int qp_u_offset, int qp_v_offset, int bd_l_m8, int bd_c_m8,
    int32_t *hy, int32_t *hu, int32_t *hv,
    int32_t *vy, int32_t *vu, int32_t *vv)
{
    int qp_off = 6 * bd_c_m8;
    size_t n = (size_t)w_scu * h_scu;
    memset(hy, 0, n * 4); memset(hu, 0, n * 4); memset(hv, 0, n * 4);
    memset(vy, 0, n * 4); memset(vu, 0, n * 4); memset(vv, 0, n * 4);
    for (int y = 0; y < h_scu; y++) {
        for (int x = 0; x < w_scu; x++) {
            int cur = y * w_scu + x;
            int qp = map_qp[cur];
            int qp_u = qp + qp_u_offset, qp_v = qp + qp_v_offset;
            if (qp_u < -qp_off) qp_u = -qp_off; if (qp_u > 57) qp_u = 57;
            if (qp_v < -qp_off) qp_v = -qp_off; if (qp_v > 57) qp_v = 57;
            if (y > 0 && edge_hor[cur]) {
                int idx = df_table_idx(map_if, map_cbfl, map_refi, map_mv,
                                       cur, cur - w_scu);
                hy[cur] = df_st[idx * 52 + qp] << bd_l_m8;
                hu[cur] = df_st[idx * 52 + qp_tab_u[qp_u + qp_off]]
                          << bd_c_m8;
                hv[cur] = df_st[idx * 52 + qp_tab_v[qp_v + qp_off]]
                          << bd_c_m8;
            }
            if (x > 0 && edge_ver[cur]) {
                int idx = df_table_idx(map_if, map_cbfl, map_refi, map_mv,
                                       cur, cur - 1);
                vy[cur] = df_st[idx * 52 + qp] << bd_l_m8;
                vu[cur] = df_st[idx * 52 + qp_tab_u[qp_u + qp_off]]
                          << bd_c_m8;
                vv[cur] = df_st[idx * 52 + qp_tab_v[qp_v + qp_off]]
                          << bd_c_m8;
            }
        }
    }
}
