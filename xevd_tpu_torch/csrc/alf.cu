// ALF, the Main profile's adaptive loop filter: one launch a picture over Y,
// U and V, one CTA a CTU.
//
// Replaces: xevd_tpu/ops/jax_alf.py `alf_apply` (K13) with `_fix_margins`
// (:32), `_classify` (:54), `_filter_luma` (:124) and `_filter_chroma`
// (:139); ref: src_main/xevdm_alf.c.  The stage runs after deblock and
// before pad (xevd_tpu/ops/pipeline.py:377-389); the wrapper is
// xevd_tpu_torch/ops/alf.py `alf_frame`.
//
// Bound on the H100: memory.  The function reads each filtered plane once
// and writes its filtered samples once: 8.3 MB for the luma of a 1080p
// picture with every CTU on, 2.5 us at 3.35 TB/s; classification and the
// 13-tap filter are about 64 integer operations a luma sample, under that.
// Luma CTUs whose flag is off are copied to the output unchanged: a cost
// of this design (the output is a plane of its own), not of the function.
//
// Design: the grid covers the luma CTUs (when luma is on), then the U and
// the V CTUs (chroma CTUs are 2^(log2_ctu - 1) samples).  Every CTU reads
// the pre-ALF area and writes a separate output plane, so no copy of the
// picture is needed.  Latency, not bytes, is what a CTA fights: each
// thread issues its loads in one batch before it stores any of them.  A
// CTA:
// - loads the clamped window (S + 6 rows of S + 8 samples from xs - 4,
//   rows and columns clamped to the picture: the replicate extension) as
//   aligned 8-byte words, sample by sample only at the picture's edge or
//   where the area is unaligned; window column cc is shared-memory column
//   cc + 1.  Where every side is available that is the window.  Else
//   `_fix_margins`' rules (the mirrors at unavailable sides, columns
//   first, the side mirrors only on rows whose mapped row is a CTU
//   interior row, :43-48) become a row map and two column maps, and the
//   window is gathered from the clamped one inside shared memory;
// - luma: stages the coefficients as a table permuted by transpose,
//   coef_t[class][trans][16] (L_TBL applied once; rows padded for 16-byte
//   reads), so the filter reads a row without a per-sample permutation;
// - luma: computes the four Laplacians once a sample over window rows and
//   columns 1 .. S + 4, summed into (S/4 + 1)^2 groups of 4 x 4 (a thread
//   a group, from 8-byte words of its 6 rows); a 4 x 4 block's sums are
//   its four groups (i .. i + 1, j .. j + 1), as `_classify`'s box sums;
//   then a thread a block classifies it.  The reference's d1 * hv0 > hv1 *
//   d0 wraps in 32 bits (and in JAX); signed overflow is undefined in C++,
//   so the products are taken as uint32_t and compared cast back to
//   int32_t;
// - filters runs of 4 samples of one 4 x 4 block's row, a thread a run:
//   one class, its coefficients in registers, the window rows read once as
//   8-byte words for the run's four outputs; round, shift and clip as the
//   reference, (acc + 256) >> 9 into [0, 2^bd - 1]; one 8-byte store.
// Luma CTUs are filtered where their flag is set and copied elsewhere;
// chroma CTUs are always filtered, as the JAX chroma mask has no CTU flag
// (:222-224).  Only samples inside the picture are written.
#include <cuda_runtime.h>
#include <stdint.h>

#define ALF_THREADS 256
#define ALF_M 3
#define ALF_CLASSES 25
#define COEF_ROW 16   // ints a row of coef_t: 13 taps, padded for 16-byte reads

namespace {

// The coefficient index of tap `tap` under transpose t (jax_alf.py
// _L_TBL), 4 bits a tap: selected and shifted, so a warp's threads never
// serialise on a table lookup.
__device__ __forceinline__ int l_tbl(int t, int tap) {
  const unsigned long long row =
      t == 0   ? 0xcba9876543210ull   // 0 1 2 3 4 5 6 7 8 9 10 11 12
      : t == 1 ? 0xc62037b518a49ull   // 9 4 10 8 1 5 11 7 3 0 2 6 12
      : t == 2 ? 0xcba9456781230ull   // 0 3 2 1 8 7 6 5 4 9 10 11 12
               : 0xc62015b734a89ull;  // 9 8 10 4 3 7 11 5 1 0 2 6 12
  return (int)((row >> (4 * tap)) & 15);
}
// _ACT_TH {0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4}, 3 bits an entry,
// and _TRANS_TBL {0, 1, 0, 2, 2, 3, 1, 3}, 2 bits an entry
constexpr unsigned long long ACT_TH3 =
    0ull | 1ull << 3 | 2ull << 6 | 2ull << 9 | 2ull << 12 | 2ull << 15 |
    2ull << 18 | 3ull << 21 | 3ull << 24 | 3ull << 27 | 3ull << 30 |
    3ull << 33 | 3ull << 36 | 3ull << 39 | 3ull << 42 | 4ull << 45;
constexpr unsigned TRANS2 = 0u | 1u << 2 | 0u << 4 | 2u << 6 | 2u << 8 |
                            3u << 10 | 1u << 12 | 3u << 14;

// One plane of the launch: the pre-ALF area `src` and the output `dst`
// (pitches in samples), the plane's picture size ph x pw and CTU size
// 2^log2_s, its CTUs across, the first CTA of its CTUs, and whether src
// and dst allow aligned 8-byte words.
struct AlfPlane {
  const int16_t* src;
  int16_t* dst;
  int spitch, dpitch, ph, pw, log2_s, n_w, first, wide;
};

struct Ctu {
  int xs, ys, wb, hb, S, N, NP;
  bool av_l, av_r, av_t, av_b;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int iabs(int a) { return a < 0 ? -a : a; }

__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)b << 16);
}

// CTU t of plane P (alf_apply :154-172, per plane: the chroma sizes are the
// luma ones >> 1).  The window is N = S + 6 samples a side; a shared-memory
// row holds NP = S + 8 samples, window column cc at NP-row offset cc + 1.
__device__ Ctu ctu_of(const AlfPlane& P, int t, int across) {
  Ctu c;
  c.S = 1 << P.log2_s;
  c.N = c.S + 2 * ALF_M;
  c.NP = c.S + 8;
  c.xs = (t % P.n_w) << P.log2_s;
  c.ys = (t / P.n_w) << P.log2_s;
  c.wb = min(c.S, P.pw - c.xs);
  c.hb = min(c.S, P.ph - c.ys);
  c.av_l = c.xs > 0;
  c.av_t = c.ys > 0;
  c.av_r = across || c.xs + c.wb != P.pw;
  c.av_b = across || c.ys + c.hb != P.ph;
  return c;
}

// shared memory: the window (int16 [N][NP]); for a CTU at an unavailable
// side, the clamped window it is mirrored from (int16 [N][NP]) and the
// row and column maps (int [3][N]); then for luma coef_t int [25 * 4][16],
// the group sums int [4][G][G] (G = S/4 + 1) and the block classes int
// [S/4][S/4]
__host__ __device__ inline int plane_bytes(int S) {
  return ((S + 2 * ALF_M) * (S + 8) * 2 + 15) & ~15;
}
__host__ __device__ inline int map_bytes(int S) {
  return (3 * (S + 2 * ALF_M) * 4 + 15) & ~15;
}
__host__ __device__ inline int win_bytes(int S) {
  return 2 * plane_bytes(S) + map_bytes(S);
}
__host__ __device__ inline int luma_extra_bytes(int S) {
  const int G = S / 4 + 1;
  return ALF_CLASSES * 4 * COEF_ROW * 4 + 4 * G * G * 4 +
         (S / 4) * (S / 4) * 4;
}

// For i in [0, n): store(i, load(i)), a thread's loads issued U at a time
// before their stores, so that a thread waits for device memory once a
// batch of U items and not once an item.
template <int U, typename T, typename Load, typename Store>
__device__ __forceinline__ void gather(int n, Load load, Store store) {
  for (int b = threadIdx.x; b < n; b += U * blockDim.x) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = b + u * blockDim.x;
      if (i < n) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = b + u * blockDim.x;
      if (i < n) store(i, v[u]);
    }
  }
}

// The clamped window of the CTU into `dst` [N][NP]: row r, column j hold
// the picture's sample (clamp(ys - M + r), clamp(xs - 4 + j)) -- the
// replicate-extended picture, window column cc at column cc + 1.  A thread
// loads words of 4 samples, aligned (xs is a multiple of 4), 8 bytes at
// once where P.wide and the word lies inside the picture, else sample by
// sample with the column clamped.
__device__ void load_clamped(int16_t* dst, const AlfPlane& P, const Ctu& c) {
  const int wpr = c.NP >> 2;
  gather<8, uint2>(
      c.N * wpr,
      [&](int i) {
        const int rr = i / wpr, x = c.xs - 4 + 4 * (i - rr * wpr);
        const int16_t* row =
            P.src + (long)clampi(c.ys - ALF_M + rr, 0, P.ph - 1) * P.spitch;
        if (P.wide && x >= 0 && x + 4 <= P.pw) return *(const uint2*)(row + x);
        const int m = P.pw - 1;
        return make_uint2(pack2(row[clampi(x, 0, m)], row[clampi(x + 1, 0, m)]),
                          pack2(row[clampi(x + 2, 0, m)],
                                row[clampi(x + 3, 0, m)]));
      },
      [&](int i, uint2 v) { *(uint2*)(dst + 4 * i) = v; });
}

// Stage the CTU's window (the caller synchronises after it).  Where every
// side is available the window is the clamped window.  Else `_fix_margins`
// maps window row rr to a clamped-window row (and whether its source is a
// CTU interior row, where the side mirrors apply) and window column cc to
// a clamped-window column for either kind of row: the clamped window and
// the maps go to shared memory first, then the window is gathered from
// them there.
__device__ void load_window(int16_t* win, const AlfPlane& P, const Ctu& c) {
  const int M = ALF_M, N = c.N, NP = c.NP;
  if (c.av_l && c.av_r && c.av_t && c.av_b) {
    load_clamped(win, P, c);
    return;
  }
  int16_t* raw = (int16_t*)((char*)win + plane_bytes(c.S));
  int* rows = (int*)((char*)raw + plane_bytes(c.S));
  int* cols = rows + N;                     // [2][N]: other rows, interior
  load_clamped(raw, P, c);
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    int rrm = t;
    if (!c.av_t && t < M) rrm = 2 * M - t;
    if (!c.av_b && t >= M + c.hb) rrm = 2 * (M + c.hb) - rrm - 2;
    const bool interior = rrm >= M && rrm < M + c.hb;
    rows[t] = clampi(rrm, 0, N - 1) << 1 | (int)interior;
    int ccm = t;
    if (!c.av_l && t < M) ccm = 2 * M - t;
    if (!c.av_r && t >= M + c.wb) ccm = 2 * (M + c.wb) - ccm - 2;
    cols[t] = t + 1;
    cols[N + t] = clampi(ccm, 0, N - 1) + 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int rr = i / N, cc = i - rr * N, ri = rows[rr];
    win[rr * NP + cc + 1] = raw[(ri >> 1) * NP + cols[(ri & 1) * N + cc]];
  }
}

// The four outputs of a run at (j, 4 k) of the CTU.
__device__ __forceinline__ void store_run(const AlfPlane& P, const Ctu& c,
                                          int j, int k, const int* o) {
  int16_t* d = P.dst + (long)(c.ys + j) * P.dpitch + c.xs + 4 * k;
  if (P.wide && 4 * k + 4 <= c.wb) {
    *(uint2*)d = make_uint2(pack2(o[0], o[1]), pack2(o[2], o[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * k + q < c.wb) d[q] = (int16_t)o[q];
  }
}

// A luma CTU whose flag is off: its samples, from the window, to the
// output unchanged (window column M is shared-memory column 4: aligned).
__device__ void copy_ctu(const AlfPlane& P, const Ctu& c,
                         const int16_t* win) {
  const int nrw = (c.wb + 3) >> 2;
  for (int i = threadIdx.x; i < c.hb * nrw; i += blockDim.x) {
    const int j = i / nrw, k = i - j * nrw;
    const int16_t* s = win + (ALF_M + j) * c.NP + 4 + 4 * k;
    int16_t* d = P.dst + (long)(c.ys + j) * P.dpitch + c.xs + 4 * k;
    if (P.wide && 4 * k + 4 <= c.wb) {
      *(uint2*)d = *(const uint2*)s;
    } else {
      for (int q = 0; q < 4 && 4 * k + q < c.wb; ++q) d[q] = s[q];
    }
  }
}

// (class << 2) | trans of a 4 x 4 block from its four Laplacian sums
// (`_classify` after the box sums).
__device__ __forceinline__ int classify(int sv, int sh, int sd0, int sd1,
                                        int bd) {
  int cls = (int)((ACT_TH3 >> (3 * clampi((sv + sh) >> (bd - 2), 0, 15))) & 7);
  const int hv1 = max(sv, sh), hv0 = min(sv, sh);
  const int dir_hv = sv > sh ? 1 : 3;
  const int d1 = max(sd0, sd1), d0 = min(sd0, sd1);
  const int dir_d = sd0 > sd1 ? 0 : 2;
  // the reference's wrapping int products (jax_alf.py:109-111)
  const bool use_d = (int32_t)((uint32_t)d1 * (uint32_t)hv0) >
                     (int32_t)((uint32_t)hv1 * (uint32_t)d0);
  const int hvd1 = use_d ? d1 : hv1, hvd0 = use_d ? d0 : hv0;
  const int main_dir = use_d ? dir_d : dir_hv;
  const int sec_dir = use_d ? dir_hv : dir_d;
  int ds = 0;
  if (hvd1 > 2 * hvd0) ds = 1;
  if (hvd1 * 2 > 9 * hvd0) ds = 2;
  if (ds > 0) cls += (((main_dir & 1) << 1) + ds) * 5;
  return (cls << 2) |
         (int)((TRANS2 >> (2 * (main_dir * 2 + (sec_dir >> 1)))) & 3);
}

// n (4, 8 or 12) samples of a window row from `p`, 8-byte aligned in
// shared memory, as 8-byte words
template <int n>
__device__ __forceinline__ void row_words(const int16_t* p, int* v) {
#pragma unroll
  for (int w = 0; w < n / 4; ++w) {
    const uint2 d = *(const uint2*)(p + 4 * w);
    v[4 * w] = (int16_t)(d.x & 0xffff);
    v[4 * w + 1] = (int)d.x >> 16;
    v[4 * w + 2] = (int16_t)(d.y & 0xffff);
    v[4 * w + 3] = (int)d.y >> 16;
  }
}

__device__ void alf_luma_ctu(const AlfPlane& P, int t,
                             const int32_t* __restrict__ coef,
                             const int32_t* __restrict__ ctu_on, int across,
                             int bd, unsigned char* smem) {
  const Ctu c = ctu_of(P, t, across);
  const bool on = ctu_on[t] > 0;    // its latency overlaps the loads below
  const int S = c.S, NP = c.NP, G = S / 4 + 1, GG = G * G;
  int16_t* win = (int16_t*)smem;
  int* coef_t = (int*)(smem + win_bytes(S));
  int* grp = coef_t + ALF_CLASSES * 4 * COEF_ROW;
  int* cls = grp + 4 * GG;
  gather<8, int>(
      ALF_CLASSES * 4 * 13,
      [&](int i) {
        const int row = i / 13, tap = i - row * 13;
        return coef[(row >> 2) * 13 + l_tbl(row & 3, tap)];
      },
      [&](int i, int v) {
        const int row = i / 13;
        coef_t[row * COEF_ROW + i - row * 13] = v;
      });
  load_window(win, P, c);
  __syncthreads();
  if (!on) {
    copy_ctu(P, c, win);
    return;
  }
  // the Laplacians of window rows and columns 1 .. S + 4, once a sample,
  // summed by 4 x 4 group: group (gi, gj) covers rows 1 + 4 gi .. 4 + 4 gi
  // and reads window rows 4 gi .. 4 gi + 5, columns 4 gj .. 4 gj + 5
  // (shared-memory columns 4 gj + 1 .. 4 gj + 6 of the words at 4 gj)
  const int nbw = (c.wb + 3) >> 2, nbh = (c.hb + 3) >> 2;
  for (int i = threadIdx.x; i < (nbh + 1) * (nbw + 1); i += blockDim.x) {
    const int gi = i / (nbw + 1), gj = i - gi * (nbw + 1);
    const int16_t* b = win + 4 * gi * NP + 4 * gj;
    int a[6][8];
#pragma unroll
    for (int r = 0; r < 6; ++r) row_words<8>(b + r * NP, a[r]);
    int sv = 0, sh = 0, sd0 = 0, sd1 = 0;
#pragma unroll
    for (int r = 1; r < 5; ++r)
#pragma unroll
      for (int x = 2; x < 6; ++x) {
        const int p2 = 2 * a[r][x];
        sv += iabs(p2 - a[r - 1][x] - a[r + 1][x]);
        sh += iabs(p2 - a[r][x - 1] - a[r][x + 1]);
        sd0 += iabs(p2 - a[r - 1][x - 1] - a[r + 1][x + 1]);
        sd1 += iabs(p2 - a[r + 1][x - 1] - a[r - 1][x + 1]);
      }
    const int g = gi * G + gj;
    grp[g] = sv;
    grp[GG + g] = sh;
    grp[2 * GG + g] = sd0;
    grp[3 * GG + g] = sd1;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbh * nbw; b += blockDim.x) {
    const int bi = b / nbw, bj = b - bi * nbw, g = bi * G + bj;
    int s[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int* q = grp + d * GG + g;
      s[d] = q[0] + q[1] + q[G] + q[G + 1];
    }
    cls[b] = classify(s[0], s[1], s[2], s[3], bd);
  }
  __syncthreads();
  // a run: CTU columns 4 k .. 4 k + 3 of row j; window row j + dy holds CTU
  // columns 4 k - 4 .. 4 k + 7 in the three words from shared-memory
  // column 4 k, so tap dx of output q is element q + dx + 4
  const int maxv = (1 << bd) - 1;
  for (int i = threadIdx.x; i < c.hb * nbw; i += blockDim.x) {
    const int j = i / nbw, k = i - j * nbw;
    const int4* cf = (const int4*)(coef_t + cls[(j >> 2) * nbw + k] * COEF_ROW);
    int f[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 w = cf[q];
      f[4 * q] = w.x, f[4 * q + 1] = w.y, f[4 * q + 2] = w.z,
      f[4 * q + 3] = w.w;
    }
    const int16_t* p = win + (ALF_M + j) * NP + 4 * k;
    int r0[12], u1[12], d1[12], u2[12], d2[12], u3[4], d3[4];
    row_words<12>(p, r0);
    row_words<12>(p - NP, u1);
    row_words<12>(p + NP, d1);
    row_words<12>(p - 2 * NP, u2);
    row_words<12>(p + 2 * NP, d2);
    row_words<4>(p - 3 * NP + 4, u3);
    row_words<4>(p + 3 * NP + 4, d3);
    int o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int acc = f[0] * (d3[q] + u3[q]) + f[1] * (d2[q + 5] + u2[q + 3]) +
                      f[2] * (d2[q + 4] + u2[q + 4]) +
                      f[3] * (d2[q + 3] + u2[q + 5]) +
                      f[4] * (d1[q + 6] + u1[q + 2]) +
                      f[5] * (d1[q + 5] + u1[q + 3]) +
                      f[6] * (d1[q + 4] + u1[q + 4]) +
                      f[7] * (d1[q + 3] + u1[q + 5]) +
                      f[8] * (d1[q + 2] + u1[q + 6]) +
                      f[9] * (r0[q + 7] + r0[q + 1]) +
                      f[10] * (r0[q + 6] + r0[q + 2]) +
                      f[11] * (r0[q + 5] + r0[q + 3]) + f[12] * r0[q + 4];
      o[q] = clampi((acc + 256) >> 9, 0, maxv);
    }
    store_run(P, c, j, k, o);
  }
}

__device__ void alf_chroma_ctu(const AlfPlane& P, int t,
                               const int32_t* __restrict__ coef, int across,
                               int bd, unsigned char* smem) {
  const Ctu c = ctu_of(P, t, across);
  const int NP = c.NP;
  int16_t* win = (int16_t*)smem;
  int f[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) f[q] = coef[q];
  load_window(win, P, c);
  __syncthreads();
  // as for luma: tap dx of output q is element q + dx + 4 of a row's words
  const int maxv = (1 << bd) - 1, nrw = (c.wb + 3) >> 2;
  for (int i = threadIdx.x; i < c.hb * nrw; i += blockDim.x) {
    const int j = i / nrw, k = i - j * nrw;
    const int16_t* p = win + (ALF_M + j) * NP + 4 * k;
    int r0[12], u1[12], d1[12], u2[4], d2[4];
    row_words<12>(p, r0);
    row_words<12>(p - NP, u1);
    row_words<12>(p + NP, d1);
    row_words<4>(p - 2 * NP + 4, u2);
    row_words<4>(p + 2 * NP + 4, d2);
    int o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int acc = f[0] * (d2[q] + u2[q]) + f[1] * (d1[q + 5] + u1[q + 3]) +
                      f[2] * (d1[q + 4] + u1[q + 4]) +
                      f[3] * (d1[q + 3] + u1[q + 5]) +
                      f[4] * (r0[q + 6] + r0[q + 2]) +
                      f[5] * (r0[q + 5] + r0[q + 3]) + f[6] * r0[q + 4];
      o[q] = clampi((acc + 256) >> 9, 0, maxv);
    }
    store_run(P, c, j, k, o);
  }
}

__global__ void __launch_bounds__(ALF_THREADS)
alf_frame_kernel(AlfPlane y, AlfPlane u, AlfPlane v,
                 const int32_t* __restrict__ coef_l,
                 const int32_t* __restrict__ ctu_on,
                 const int32_t* __restrict__ coef_c, int across, int bd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  if (b < u.first)
    alf_luma_ctu(y, b, coef_l, ctu_on, across, bd, smem);
  else if (b < v.first)
    alf_chroma_ctu(u, b - u.first, coef_c, across, bd, smem);
  else
    alf_chroma_ctu(v, b - v.first, coef_c, across, bd, smem);
}

inline AlfPlane plane(const void* src, int spitch, void* dst, int dpitch,
                      int ph, int pw, int log2_s, int wide, int first) {
  AlfPlane p;
  p.src = (const int16_t*)src;
  p.dst = (int16_t*)dst;
  p.spitch = spitch, p.dpitch = dpitch, p.ph = ph, p.pw = pw;
  p.log2_s = log2_s;
  p.n_w = (pw + (1 << log2_s) - 1) >> log2_s;
  p.wide = wide;
  p.first = first;
  return p;
}

inline int n_ctus(int ph, int pw, int log2_s) {
  const int S = 1 << log2_s;
  return ((ph + S - 1) >> log2_s) * ((pw + S - 1) >> log2_s);
}

}  // namespace

// The planes of an h x w picture, CTU 2^log2_ctu: Y (src ysrc, pitch
// yspitch, output ydst, pitch ydpitch), U and V (h/2 x w/2, CTU
// 2^(log2_ctu - 1)).  `planes` bit 0, 1, 2: Y, U, V filtered (a plane not
// filtered is not read and needs no pointers); `wide` the same bits: the
// plane's src and dst allow aligned 8-byte words.  coef_l [25, 13] with the
// CTU flags ctu_on [n_ctu] (luma), coef_c [7] (chroma).
extern "C" int xevd_alf_frame(const void* ysrc, int yspitch, void* ydst,
                              int ydpitch, const void* usrc, int uspitch,
                              void* udst, int udpitch, const void* vsrc,
                              int vspitch, void* vdst, int vdpitch, int h,
                              int w, int log2_ctu, int planes, int wide,
                              const void* coef_l, const void* ctu_on,
                              const void* coef_c, int across, int bd,
                              void* stream) {
  static int smem_set = 48 * 1024;  // the launch's shared memory limit
  const int ny = planes & 1 ? n_ctus(h, w, log2_ctu) : 0;
  const int nu = planes & 2 ? n_ctus(h >> 1, w >> 1, log2_ctu - 1) : 0;
  const int nv = planes & 4 ? n_ctus(h >> 1, w >> 1, log2_ctu - 1) : 0;
  const AlfPlane py = plane(ysrc, yspitch, ydst, ydpitch, h, w, log2_ctu,
                            wide & 1, 0);
  const AlfPlane pu = plane(usrc, uspitch, udst, udpitch, h >> 1, w >> 1,
                            log2_ctu - 1, (wide >> 1) & 1, ny);
  const AlfPlane pv = plane(vsrc, vspitch, vdst, vdpitch, h >> 1, w >> 1,
                            log2_ctu - 1, (wide >> 2) & 1, ny + nu);
  const int S = 1 << log2_ctu;
  int smem = nu + nv ? win_bytes(S >> 1) : 0;
  if (ny) smem = win_bytes(S) + luma_extra_bytes(S);
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        alf_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  if (ny + nu + nv > 0)
    alf_frame_kernel<<<ny + nu + nv, ALF_THREADS, smem,
                       (cudaStream_t)stream>>>(py, pu, pv,
                                               (const int32_t*)coef_l,
                                               (const int32_t*)ctu_on,
                                               (const int32_t*)coef_c, across,
                                               bd);
  return (int)cudaGetLastError();
}
