// Baseline deblocking, in place on the SCU-cropped picture area.
//
// Replaces: xevd_tpu/ops/jax_deblock.py `luma_ver_pass`, `luma_hor_pass`
// (K8, `_luma_filter`), `chroma_ver_pass`, `chroma_hor_pass` (K9,
// `_chroma_filter`; ref: src_base/xevd_df.c:96-195) and `chroma_ver_ordered`
// (K10, the SUCO-order chroma vertical edges).  The function that runs
// them (luma, chroma ver, chroma hor) is xevd_tpu_torch/ops/deblock.py
// `deblock_frame` (K12).
//
// Bound on the H100: memory.  Each edge line reads and writes at most 4
// samples and does a dozen integer operations; there is no reuse.  The
// kernels read the per-SCU strength maps themselves instead of
// materialising the repeated maps of the JAX version.  Division is C
// truncating division (`_div_trunc`), not an arithmetic shift.
//
// K8, both luma passes in one launch.  A vertical edge at x = 4e reads
// and writes columns 4e - 2 .. 4e + 1, a horizontal edge at y = 4f rows
// 4f - 2 .. 4f + 1.  So the shifted 4x4 block (f, e), rows 4f - 2 .. 4f + 1
// by columns 4e - 2 .. 4e + 1, is closed under "ver, then hor": every
// sample a horizontal edge of the block reads was last written by a
// vertical edge of the same block, and no two blocks share a sample
// (ops/deblock.py `luma_blocks_ref` is the plain statement).  The chroma
// passes that run between the two luma passes in the reference order
// touch only U and V.  `luma_kernel` takes a thread a block, f <= H / 4,
// e <= W / 4 (the blocks on the area's sides clipped to it), a warp over
// 32 consecutive blocks of a block row: the block's four strengths are
// loaded first, and a block without any returns before it loads a sample;
// else its rows are two 32-bit words each (columns 4e - 2, 4e - 1 and 4e,
// 4e + 1: a warp's load of a row is 256 contiguous bytes), only the words
// a strength reaches are loaded, all 16 samples stay in registers through
// both filters, and the words loaded are stored.  The area must be 4-byte
// aligned with an even row pitch (the wrapper raises otherwise).
//
// K9, the chroma cascade.  Chroma edges are 2 px apart: edge e at 2e reads
// A, B, C, D at 2e - 2 .. 2e + 1 and writes B and C, and its only input
// from an earlier edge is A, which edge e - 1 wrote as its C (the lax.scan
// carry of the JAX version).  B, C, D and the strength are never written by
// an earlier edge.  So the cascade breaks wherever an edge has strength 0:
// the runs of consecutive nonzero edges are independent, and each is a
// chain that carries A in a register (ops/deblock.py `chroma_runs_ref` is
// the plain statement of this order).  Both passes stage their samples and
// strengths in shared memory with coalesced loads, find the run heads (an
// edge with a strength whose previous edge has none), walk each run in one
// thread with A, and the next B, in registers, and write the staged samples
// back coalesced.  The two chroma lines (columns) of an SCU row (column)
// share their strengths, so one thread walks a run on both at once.
//   chroma_ver: one warp per SCU row (its two lines), CV_WARPS rows a CTA;
//     the heads are compacted with a warp ballot and dealt to the lanes.
//   chroma_hor: a CTA per tile of tw columns and the whole height, a thread
//     per (column pair, segment of the edges): it walks the runs whose head
//     lies in its segment, past the segment's end where a run goes on.
// A run that spans a whole row (all 479 edges of a 1080p chroma line) is
// one thread's serial walk: a few dozen cycles a step, all on chip.
//
// K10: under SUCO a row's chroma edges cascade in the order of the per-CU
// deblock visit, not left to right.  The JAX version scans waves of at
// most one edge per SCU row.  Two edges interact only where they are 2
// samples apart (or repeat a column) and both filter in that plane: an
// edge at x reads x - 2 .. x + 1 and writes x - 1, x.  So the host splits
// each row's list (ops/pack.py `chroma_ver_edges`) per plane into runs --
// maximal sets of edge columns 2 samples apart with a strength in the
// plane, each run's edges in list order (`suco_runs`; ops/deblock.py
// `chroma_ver_runs_ref` is the plain statement) -- and the kernel takes a
// CTA per SCU row: the row's two lines of U and V and its run table are
// staged in shared memory with coalesced loads, a thread walks each run
// on both lines at once, and the lines are written back coalesced.  One
// launch a frame, no waves; the dependency chain is the longest run, one
// shared-memory round trip a step, not the longest row list through
// device memory.
//
// GOP batch (K15): K8 and the two K9 passes filter the areas of the G
// frames of one time step in one launch each, frame g in blockIdx.z (K8)
// or blockIdx.y (K9), at g times the batch strides of the areas and of the
// strength maps.
#include <cuda_runtime.h>
#include <stdint.h>

#define LB_ROWS 4          // K8: block rows a CTA (a warp each)
#define CV_MAX_WARPS 2     // chroma_ver: SCU rows a CTA (at most)
#define CH_THREADS 256     // chroma_hor: threads a CTA
#define CH_MIN_CTAS 256    // chroma_hor: CTAs a launch should give
#define DB_SMEM (48 << 10) // dynamic shared memory a chroma CTA may take
#define CO_THREADS 256     // K10: threads a CTA (an SCU row)
#define CO_SMEM_MAX 232448 // K10: the most shared memory a CTA can have

namespace {

__device__ __forceinline__ int div_trunc(int a, int k) {
  const int q = (a < 0 ? -a : a) >> k;
  return a < 0 ? -q : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// d1 and the clip of the shared part of both filters
__device__ __forceinline__ int edge_delta(int A, int B, int C, int D, int st,
                                          int* clip_out) {
  const int d = div_trunc(A - B * 4 + C * 4 - D, 3);
  const int abs_d = d < 0 ? -d : d;
  const int t16 = max(0, (abs_d - st) * 2);
  const int clip = max(0, abs_d - t16);
  *clip_out = clip;
  return d < 0 ? -clip : clip;
}

// One luma edge of strength st > 0 across samples A, B | C, D, in place.
__device__ __forceinline__ void luma_step(int& A, int& B, int& C, int& D,
                                          int st, int maxv) {
  int clip;
  const int d1 = edge_delta(A, B, C, D, st, &clip);
  const int clip2 = clip >> 1;
  const int d2 = clampi(div_trunc(A - D, 2), -clip2, clip2);
  const int a = clampi(A - d2, 0, maxv), b = clampi(B + d1, 0, maxv);
  C = clampi(C - d1, 0, maxv);
  D = clampi(D + d2, 0, maxv);
  A = a;
  B = b;
}

// One chroma edge of strength st > 0 on samples A, B, C, D: the new B and
// C.  The clip of `edge_delta`, max(0, |d| - max(0, 2 (|d| - st))), is
// max(0, min(|d|, 2 st - |d|)): three operations on the chain through A.
__device__ __forceinline__ void chroma_step(int A, int B, int C, int D,
                                            int st, int maxv, int& nb,
                                            int& nc) {
  const int v = A - B * 4 + C * 4 - D;
  const int a = (v < 0 ? -v : v) >> 3;
  const int clip = max(0, min(a, 2 * st - a));
  const int d1 = v < 0 ? -clip : clip;
  nb = clampi(B + d1, 0, maxv);
  nc = clampi(C - d1, 0, maxv);
}

// two int16 samples (two lines or columns) in one 32-bit word
__device__ __forceinline__ int lo16(uint32_t w) {
  return (int16_t)(w & 0xffff);
}
__device__ __forceinline__ int hi16(uint32_t w) { return (int16_t)(w >> 16); }
__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

// Walks the run of edges that starts at `e` on a pair of lines whose
// samples are the words x[i * xp], i < 2 ne (both lines' sample i), with
// strengths s[e * sp]; returns the first edge after the run (strength
// <= 0, or ne).
__device__ __forceinline__ int chroma_run(uint32_t* x, int xp,
                                          const int32_t* s, int sp, int e,
                                          int ne, int maxv) {
  uint32_t A = x[(2 * e - 2) * xp], B = x[(2 * e - 1) * xp];
  uint32_t C = x[2 * e * xp], D = x[(2 * e + 1) * xp];
  int st = s[e * sp];
  for (;;) {
    // the next edge's C, D and strength, which this edge does not write,
    // load while this edge's chain computes
    const bool more = e + 1 < ne;
    uint32_t nC = 0, nD = 0;
    int nst = 0;
    if (more) {
      nst = s[(e + 1) * sp];
      nC = x[(2 * e + 2) * xp];
      nD = x[(2 * e + 3) * xp];
    }
    int b0, c0, b1, c1;
    chroma_step(lo16(A), lo16(B), lo16(C), lo16(D), st, maxv, b0, c0);
    chroma_step(hi16(A), hi16(B), hi16(C), hi16(D), st, maxv, b1, c1);
    const uint32_t nc = pack16(c0, c1);
    x[(2 * e - 1) * xp] = pack16(b0, b1);
    x[2 * e * xp] = nc;
    ++e;
    if (!more || nst <= 0) return e;
    A = nc;   // the next edge's A is this edge's C
    B = D;    // and its B this edge's D, which no edge has written
    C = nC;
    D = nD;
    st = nst;
  }
}

// K8: area [H, W] with row pitch `stride` (even; the area 4-byte
// aligned); stv, sth [H/4, W/4]: the strength of the vertical edge left of
// and of the horizontal edge above each 4x4 (0 = none; a null map: no
// edge of that direction).  Grid (x: 32 blocks, y: LB_ROWS block rows, z:
// the frame g of a GOP batch, at g times the batch strides).
__global__ void __launch_bounds__(32 * LB_ROWS)
luma_kernel(int16_t* area, int stride, int H, int W,
            const int32_t* __restrict__ stv, const int32_t* __restrict__ sth,
            int maxv, long long area_bs, long long stv_bs,
            long long sth_bs) {
  const int hs = H >> 2, ws = W >> 2;
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int f = blockIdx.y * LB_ROWS + threadIdx.y;
  if (e > ws || f > hs) return;
  // ver strengths of the upper two rows (SCU row f - 1) and the lower two
  // (f); hor strengths of word 0 (SCU column e - 1) and word 1 (e).  The
  // area's sides are no edges.
  int sv0 = 0, sv1 = 0, sh0 = 0, sh1 = 0;
  if (stv != nullptr && e >= 1 && e < ws) {
    const int32_t* s = stv + blockIdx.z * stv_bs + e;
    if (f >= 1) sv0 = s[(long)(f - 1) * ws];
    if (f < hs) sv1 = s[(long)f * ws];
  }
  if (sth != nullptr && f >= 1 && f < hs) {
    const int32_t* s = sth + blockIdx.z * sth_bs + (long)f * ws + e;
    if (e >= 1) sh0 = s[-1];
    if (e < ws) sh1 = s[0];
  }
  if (sv0 <= 0 && sv1 <= 0 && sh0 <= 0 && sh1 <= 0) return;
  // word (i, j): row 4f - 2 + i, columns 4e - 2 + 2j, 4e - 1 + 2j; the one
  // a strength reaches is in the area (a ver strength only where e and
  // the row are inside, a hor one only where f is, and word j's column)
  uint32_t* p = (uint32_t*)(area + blockIdx.z * area_bs
                            + (long)(4 * f - 2) * stride + 4 * e - 2);
  const long pw = stride >> 1;   // row pitch in words
  bool on[4][2];
  int x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool v = (i < 2 ? sv0 : sv1) > 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      on[i][j] = v || (j ? sh1 : sh0) > 0;
      const uint32_t w = on[i][j] ? p[i * pw + j] : 0u;
      x[i][2 * j] = lo16(w);
      x[i][2 * j + 1] = hi16(w);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = i < 2 ? sv0 : sv1;
    if (s > 0) luma_step(x[i][0], x[i][1], x[i][2], x[i][3], s, maxv);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int s = c < 2 ? sh0 : sh1;
    if (s > 0) luma_step(x[0][c], x[1][c], x[2][c], x[3][c], s, maxv);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (on[i][j]) p[i * pw + j] = pack16(x[i][2 * j], x[i][2 * j + 1]);
}

// chroma area [H, W]; st [H/2, W/2] per SCU.  A warp per SCU row: its two
// lines (interleaved, one 32-bit word a column) and its strength row are
// staged in shared memory, the run heads compacted by ballot, each run
// walked by one lane.  Shared memory a warp: cv_warp_bytes(W).
__host__ __device__ __forceinline__ int cv_warp_bytes(int W) {
  return (W * 4 + (W >> 1) * 4 + (W >> 1) * 2 + 15) & ~15;  // lines, st, heads
}

__global__ void __launch_bounds__(CV_MAX_WARPS * 32)
chroma_ver_kernel(int16_t* area, int stride, int H, int W,
                  const int32_t* __restrict__ st, int maxv,
                  long long area_bs, long long st_bs) {
  extern __shared__ __align__(16) unsigned char db_smem[];
  area += blockIdx.y * area_bs;
  st += blockIdx.y * st_bs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rs = blockIdx.x * (blockDim.x >> 5) + warp;   // SCU row
  if (2 * rs >= H) return;                                  // warp-uniform
  const int ws = W >> 1;
  uint32_t* x = (uint32_t*)(db_smem + (size_t)warp * cv_warp_bytes(W));
  int32_t* s = (int32_t*)(x + W);
  int16_t* heads = (int16_t*)(s + ws);
  int16_t* r0 = area + (long)(2 * rs) * stride;
  int16_t* r1 = r0 + stride;
  const int32_t* srow = st + (long)rs * ws;
#pragma unroll 4
  for (int i = lane; i < ws; i += 32) s[i] = srow[i];
#pragma unroll 4
  for (int i = lane; i < W; i += 32) x[i] = pack16(r0[i], r1[i]);
  __syncwarp();
  // run heads: edge e (1 <= e < ws) with a strength whose edge e - 1 has
  // none (edge 0, the area's left side, is no edge)
  int nh = 0;
  for (int e0 = 1; e0 < ws; e0 += 32) {
    const int e = e0 + lane;
    const bool head = e < ws && s[e] > 0 && (e == 1 || s[e - 1] <= 0);
    const unsigned m = __ballot_sync(0xffffffffu, head);
    if (head) heads[nh + __popc(m & ((1u << lane) - 1))] = (int16_t)e;
    nh += __popc(m);
  }
  if (nh == 0) return;                                      // warp-uniform
  __syncwarp();
  for (int k = lane; k < nh; k += 32)
    chroma_run(x, 1, s, 1, heads[k], ws, maxv);
  __syncwarp();
  for (int i = lane; i < W; i += 32) {
    const uint32_t w = x[i];
    r0[i] = (int16_t)lo16(w);
    r1[i] = (int16_t)hi16(w);
  }
}

// A CTA per tile of tw columns (tw even) over the whole height: the tile
// (as tw / 2 column pairs, one 32-bit word a pair and row) and its
// strength columns staged in shared memory, ch_tile_bytes(H, tw); a thread
// per (column pair, segment of the edges) walks the runs whose heads lie
// in its segment.
__host__ __device__ __forceinline__ int ch_tile_bytes(int H, int tw) {
  return H * tw * 2 + (H >> 1) * (tw >> 1) * 4;   // samples, strengths
}

__global__ void __launch_bounds__(CH_THREADS)
chroma_hor_kernel(int16_t* area, int stride, int H, int W,
                  const int32_t* __restrict__ st, int maxv,
                  long long area_bs, long long st_bs, int tw) {
  extern __shared__ __align__(16) unsigned char db_smem[];
  area += blockIdx.y * area_bs;
  st += blockIdx.y * st_bs;
  const int ws = W >> 1, ne = H >> 1, tp = tw >> 1;
  const int c0 = blockIdx.x * tw, cp = min(tw, W - c0) >> 1;  // pairs here
  uint32_t* x = (uint32_t*)db_smem;          // [H][tp]
  int32_t* s = (int32_t*)(x + H * tp);       // [ne][tp]
#pragma unroll 4
  for (int i = threadIdx.x; i < ne * tp; i += blockDim.x) {
    const int r = i / tp, p = i - r * tp;
    s[i] = p < cp ? st[(long)r * ws + (c0 >> 1) + p] : 0;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < H * tp; i += blockDim.x) {
    const int r = i / tp, p = i - r * tp;
    const int16_t* q = area + (long)r * stride + c0 + 2 * p;
    x[i] = p < cp ? pack16(q[0], q[1]) : 0;
  }
  __syncthreads();
  const int p = threadIdx.x % tp, k = threadIdx.x / tp;
  const int nseg = blockDim.x / tp, L = (ne - 1 + nseg - 1) / nseg;
  const int e_lo = 1 + k * L, e_hi = min(e_lo + L, ne);
  bool any = false;
  if (p < cp) {
    for (int e = e_lo; e < e_hi; ++e) {
      if (s[e * tp + p] <= 0 || (e > 1 && s[(e - 1) * tp + p] > 0)) continue;
      any = true;
      e = chroma_run(x + p, tp, s + p, tp, e, ne, maxv);
    }
  }
  if (!__syncthreads_or(any)) return;        // no edge in the tile
  for (int i = threadIdx.x; i < H * tp; i += blockDim.x) {
    const int r = i / tp, p2 = i - r * tp;
    if (p2 < cp) {
      int16_t* q = area + (long)r * stride + c0 + 2 * p2;
      q[0] = (int16_t)lo16(x[i]);
      q[1] = (int16_t)hi16(x[i]);
    }
  }
}

// K10: a CTA per SCU row.  u, v [H, W] (H = 2 h_scu), one row pitch; the
// run table of ops/pack.py `SucoRuns`: row_runs [2 h_scu + 1] (the runs of
// row r in U, then in V), run_off [R + 1], entries x | st << 16.  The
// row's two lines of U and of V (one 32-bit word a column: both lines'
// samples) and its entries and run offsets are staged in shared memory
// (cv_runs_bytes), each run walked by one thread in list order on both
// lines at once, the lines written back.  A row without runs returns at
// once.  The pack checks 2 <= x <= W - 2.
__host__ __device__ __forceinline__ int cv_runs_bytes(int W, int runs,
                                                      int entries) {
  return 2 * W * 4 + (runs + 1) * 4 + entries * 4;
}

__global__ void __launch_bounds__(CO_THREADS)
chroma_ver_runs_kernel(int16_t* u, int16_t* v, int stride, int W,
                       const int32_t* __restrict__ row_runs,
                       const int32_t* __restrict__ run_off,
                       const int32_t* __restrict__ entries, int maxv) {
  extern __shared__ __align__(16) unsigned char db_smem[];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int k0 = row_runs[2 * r], kv = row_runs[2 * r + 1] - k0;
  const int nr = row_runs[2 * r + 2] - k0;
  if (nr == 0) return;                       // no edge in this SCU row
  const int e0 = run_off[k0], ne = run_off[k0 + nr] - e0;
  uint32_t* xs = (uint32_t*)db_smem;         // [2][W]: U, V
  int32_t* ro = (int32_t*)(xs + 2 * W);      // [nr + 1], from e0
  int32_t* es = ro + nr + 1;                 // [ne]
  int16_t* u0 = u + (long)(2 * r) * stride;
  int16_t* v0 = v + (long)(2 * r) * stride;
#pragma unroll 4
  for (int i = tid; i < W; i += CO_THREADS) {
    xs[i] = pack16(u0[i], u0[i + stride]);
    xs[W + i] = pack16(v0[i], v0[i + stride]);
  }
  for (int i = tid; i <= nr; i += CO_THREADS) ro[i] = run_off[k0 + i] - e0;
  for (int i = tid; i < ne; i += CO_THREADS) es[i] = entries[e0 + i];
  __syncthreads();
  for (int k = tid; k < nr; k += CO_THREADS) {
    uint32_t* x = xs + (k >= kv ? W : 0);
    const int end = ro[k + 1];
    for (int e = ro[k]; e < end; ++e) {
      const int w = es[e], c = w & 0xffff, st = w >> 16;
      const uint32_t A = x[c - 2], B = x[c - 1], C = x[c], D = x[c + 1];
      int b0, c0, b1, c1;
      chroma_step(lo16(A), lo16(B), lo16(C), lo16(D), st, maxv, b0, c0);
      chroma_step(hi16(A), hi16(B), hi16(C), hi16(D), st, maxv, b1, c1);
      x[c - 1] = pack16(b0, b1);
      x[c] = pack16(c0, c1);
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < W; i += CO_THREADS) {
    const uint32_t a = xs[i], b = xs[W + i];
    u0[i] = (int16_t)lo16(a);
    u0[i + stride] = (int16_t)hi16(a);
    v0[i] = (int16_t)lo16(b);
    v0[i + stride] = (int16_t)hi16(b);
  }
}

}  // namespace

// K8 over G frames (G 1: one frame), the areas area_bs and the maps
// stv_bs, sth_bs elements apart; stv or sth may be null (no edge of that
// direction).  H and W multiples of 4, the area 4-byte aligned, the row
// pitch and area_bs even: else refused.
extern "C" int xevd_deblock_luma(void* area, int stride, int H, int W,
                                 const void* stv, const void* sth, int bd,
                                 int G, long long area_bs, long long stv_bs,
                                 long long sth_bs, void* stream) {
  if ((H | W) & 3 || (stride | area_bs) & 1 || (uintptr_t)area & 3)
    return (int)cudaErrorInvalidValue;
  if (H > 0 && W > 0 && G > 0 && (stv != nullptr || sth != nullptr))
    luma_kernel<<<dim3(((W >> 2) + 32) / 32,
                       ((H >> 2) + LB_ROWS) / LB_ROWS, G),
                  dim3(32, LB_ROWS), 0, (cudaStream_t)stream>>>(
        (int16_t*)area, stride, H, W, (const int32_t*)stv,
        (const int32_t*)sth, (1 << bd) - 1, area_bs, stv_bs, sth_bs);
  return (int)cudaGetLastError();
}

// G frames (blockIdx.y), the areas area_bs and the strength maps st_bs
// elements apart; G 1 is one frame.
// The chroma passes take H and W even (2 x the SCU grid); a line (a
// column) too long for DB_SMEM of staging is refused.
extern "C" int xevd_deblock_chroma_ver(void* area, int stride, int H, int W,
                                       const void* st, int bd, int G,
                                       long long area_bs, long long st_bs,
                                       void* stream) {
  const int per = cv_warp_bytes(W);
  if (per > DB_SMEM || (H | W) & 1) return (int)cudaErrorInvalidValue;
  const int wpc = per * CV_MAX_WARPS <= DB_SMEM ? CV_MAX_WARPS : 1;
  const int rows = H >> 1;
  if (rows > 0 && W > 2 && G > 0)
    chroma_ver_kernel<<<dim3((rows + wpc - 1) / wpc, G), 32 * wpc,
                        per * wpc, (cudaStream_t)stream>>>(
        (int16_t*)area, stride, H, W, (const int32_t*)st, (1 << bd) - 1,
        area_bs, st_bs);
  return (int)cudaGetLastError();
}

extern "C" int xevd_deblock_chroma_hor(void* area, int stride, int H, int W,
                                       const void* st, int bd, int G,
                                       long long area_bs, long long st_bs,
                                       void* stream) {
  // the widest tile (at most 16 columns) that fits and still gives
  // CH_MIN_CTAS CTAs, enough to spread over the card's 132 SMs
  int tw = 16;
  while (tw > 4 && (long long)((W + tw - 1) / tw) * G < CH_MIN_CTAS)
    tw >>= 1;
  while (tw > 2 && ch_tile_bytes(H, tw) > DB_SMEM) tw >>= 1;
  if (ch_tile_bytes(H, tw) > DB_SMEM || (H | W) & 1)
    return (int)cudaErrorInvalidValue;
  if (H > 2 && W > 0 && G > 0)
    chroma_hor_kernel<<<dim3((W + tw - 1) / tw, G), CH_THREADS,
                        ch_tile_bytes(H, tw), (cudaStream_t)stream>>>(
        (int16_t*)area, stride, H, W, (const int32_t*)st, (1 << bd) - 1,
        area_bs, st_bs, tw);
  return (int)cudaGetLastError();
}

// K10 over the run table; runs_max and entries_max: the most runs and
// entries of one SCU row (ops/pack.py `SucoRuns`), which size the CTA's
// shared memory.
extern "C" int xevd_chroma_ver_ordered(void* u, void* v, int stride, int H,
                                       int W, const void* row_runs,
                                       const void* run_off,
                                       const void* entries, int runs_max,
                                       int entries_max, int bd,
                                       void* stream) {
  const int smem = cv_runs_bytes(W, runs_max, entries_max);
  if (smem > CO_SMEM_MAX || (H & 1)) return (int)cudaErrorInvalidValue;
  if (smem > DB_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        chroma_ver_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (H > 0 && runs_max > 0)
    chroma_ver_runs_kernel<<<H >> 1, CO_THREADS, smem,
                             (cudaStream_t)stream>>>(
        (int16_t*)u, (int16_t*)v, stride, W, (const int32_t*)row_runs,
        (const int32_t*)run_off, (const int32_t*)entries, (1 << bd) - 1);
  return (int)cudaGetLastError();
}
