// ADDB, the Main profile's advanced deblocking: one launch a picture over Y,
// U and V, the six passes fused over shifted blocks, in place on the
// H8 x W8 picture areas.
//
// Replaces: xevd_tpu/ops/jax_deblock.py `addb_luma_ver`, `addb_luma_hor`,
// `addb_chroma_ver`, `addb_chroma_hor` (K11; line filters
// xevd_tpu/ops/addb_common.py `luma_line` :21, `chroma_line` :87; ref:
// src_main/xevdm_df.c:550-781), run in the order of K12
// `_deblock_finish_addb` (xevd_tpu/ops/pipeline.py:251-281: luma ver,
// chroma ver U and V, luma hor, chroma hor U and V); the wrapper is
// xevd_tpu_torch/ops/addb.py `addb_frame`.
//
// The rule that makes fusion exact: a luma edge at x = 8 e reads columns
// 8 e - 4 .. 8 e + 3 of its row and writes 8 e - 3 .. 8 e + 2, and a
// horizontal edge does the same across rows.  So the shifted block
// [8 r - 4, 8 r + 4) x [8 c - 4, 8 c + 4) is closed under "ver pass, then
// hor pass": its horizontal edge reads only samples whose vertical result
// came from samples of the same block, and no edge of either pass reads
// what another block writes.  Chroma is the same with 4 x 4 blocks shifted
// by 2 (edges every 4 samples, reading 2 and writing 1 a side), and chroma
// never reads luma, so the reference order only says "ver before hor"
// inside a plane.  `ops/addb.py` `addb_blocks_ref` states this rule in
// plain PyTorch: every block order gives JAX's result.
//
// Bound on the H100: memory.  The function reads once each sample an edge
// with bs > 0 reads, writes once each it writes, and reads the cells on
// the edge grid (bs, and the other three channels where bs > 0): 7.9 MB on
// the 1080p config-3 picture 0, 2.4 us at 3.35 TB/s; the line filters are
// some 60 integer operations a luma line, far below that.  The int32 maps
// as stored are 11.4 MB a 1080p picture against 6.2 MB of samples.
//
// Design: one CTA a tile of 16 x 128 samples of whole shifted blocks (luma
// 2 x 16 blocks, chroma 4 x 32), the grid covering Y's tiles, then U's,
// then V's (U reads chroma channels 0, 1, 2, 3, V 0, 4, 5, 6).  A thread
// first loads the parameter cells of its lines (luma one vertical and one
// horizontal line, chroma two of each), so that their latency overlaps
// the tile's load.  The tile comes into shared memory as aligned words --
// 4 samples (8 bytes) luma, 2 samples (4 bytes) chroma: the block grid's
// shift is one word, so every word of the tile is aligned and a warp
// reads whole sectors -- or, where the wrapper found the area's base or
// pitch unaligned, sample by sample; a thread issues all its loads before
// its stores.  Then a thread a (row, edge) runs the vertical edges, each
// line one 16-byte (luma) or 8-byte (chroma) shared-memory access; a
// barrier; a thread a (column, edge) runs the horizontal edges; a
// barrier; the tile goes back as it came.  Border blocks are partial:
// columns and rows [0, 4) and the last 4 carry no edge of their own, and a
// word outside the area is neither read nor written.
#include <cuda_runtime.h>
#include <stdint.h>

#define ADDB_THREADS 256
#define TILE_H 16
#define TILE_W 128

namespace {

// One plane of the launch: the area [H, W] (row pitch `pitch` samples), its
// parameter map [2, H / u, W / u, nch] (u = 4 luma, 2 chroma; [0] vertical,
// [1] horizontal edges) with (alpha, beta, c) at channels cb .. cb + 2, its
// tiles across, and the first CTA of its tiles.
struct Plane {
  int16_t* area;
  const int32_t* pars;
  int pitch, H, W, nch, cb, tiles_x, first, wide;
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);  // addb_common._clip3: min(max(v, lo), hi)
}

__device__ __forceinline__ int iabs(int a) { return a < 0 ? -a : a; }

// An edge's parameter cell: bs, alpha, beta, c (c1 luma, c0 chroma).
struct Cell {
  int bs, alpha, beta, c;
};

// v = p3 p2 p1 p0 q0 q1 q2 q3 across the edge; filters v in place, false
// where the line stays as it is.
__device__ __forceinline__ bool luma_line(int* v, const Cell& P, int bd) {
  const int bs = P.bs, alpha = P.alpha, beta = P.beta, c1 = P.c;
  if (bs <= 0) return false;
  const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
  const int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return false;
  const int maxv = (1 << bd) - 1;
  const bool ap = iabs(p0 - p2) < beta, aq = iabs(q0 - q2) < beta;
  int fp0, fp1, fp2, fq0, fq1, fq2;
  if (bs == 4) {  // strong filter (xevdm_df.c:633-651)
    const bool sthr = iabs(p0 - q0) < ((alpha >> 2) + 2);
    const bool p_on = ap && sthr, q_on = aq && sthr;
    fp0 = p_on ? (p2 + 2 * (p1 + p0 + q0) + q1 + 4) >> 3
               : (2 * p1 + p0 + q1 + 2) >> 2;
    fp1 = p_on ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
    fp2 = p_on ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
    fq0 = q_on ? (q2 + 2 * (q1 + q0 + p0) + p1 + 4) >> 3
               : (2 * q1 + q0 + p1 + 2) >> 2;
    fq1 = q_on ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
    fq2 = q_on ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
  } else {  // normal filter (:652-690)
    const int shift = bd > 9 ? bd - 9 : 0;
    const int c0 = c1 + (((int)ap + (int)aq) << shift);
    const int d0 = clip3(-c0, c0, (4 * (q0 - p0) + p1 - q1 + 4) >> 3);
    fp0 = clip3(0, maxv, p0 + d0);
    fq0 = clip3(0, maxv, q0 - d0);
    const int d1p = clip3(-c1, c1, ((p2 + p0 + q0) * 3 - 8 * p1 - q1) >> 4);
    const int d1q = clip3(-c1, c1, ((q2 + q0 + p0) * 3 - 8 * q1 - p1) >> 4);
    fp1 = ap ? p1 + d1p : p1;
    fq1 = aq ? q1 + d1q : q1;
    fp2 = p2;
    fq2 = q2;
  }
  // final clip of taps 0..2 (:691-699)
  v[3] = clip3(0, maxv, fp0);
  v[2] = clip3(0, maxv, fp1);
  v[1] = clip3(0, maxv, fp2);
  v[4] = clip3(0, maxv, fq0);
  v[5] = clip3(0, maxv, fq1);
  v[6] = clip3(0, maxv, fq2);
  return true;
}

// v = p1 p0 q0 q1 across the edge.
__device__ __forceinline__ bool chroma_line(int* v, const Cell& P, int bd) {
  const int bs = P.bs, alpha = P.alpha, beta = P.beta, c0 = P.c;
  if (bs <= 0) return false;
  const int p1 = v[0], p0 = v[1], q0 = v[2], q1 = v[3];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return false;
  const int maxv = (1 << bd) - 1;
  int fp0, fq0;
  if (bs == 4) {  // (xevdm_df.c:710-781)
    fp0 = (2 * p1 + p0 + q1 + 2) >> 2;
    fq0 = (2 * q1 + q0 + p1 + 2) >> 2;
  } else {
    const int d0 = clip3(-c0, c0, (4 * (q0 - p0) + p1 - q1 + 4) >> 3);
    fp0 = clip3(0, maxv, p0 + d0);
    fq0 = clip3(0, maxv, q0 - d0);
  }
  v[1] = clip3(0, maxv, fp0);
  v[2] = clip3(0, maxv, fq0);
  return true;
}

template <int B>
__device__ __forceinline__ bool line(int* v, const Cell& P, int bd) {
  if constexpr (B == 8) return luma_line(v, P, bd);
  else return chroma_line(v, P, bd);
}

// The cell at `p` (channel 0 bs, channels cb .. cb + 2 alpha, beta, c); a
// cell whose bs is 0 needs nothing more.
__device__ __forceinline__ Cell load_cell(const int32_t* p, int cb) {
  Cell c;
  c.bs = p[0];
  c.alpha = p[cb];
  c.beta = p[cb + 1];
  c.c = p[cb + 2];
  return c;
}

__device__ __forceinline__ int lo16(uint32_t w) {
  return (int16_t)(w & 0xffff);
}
__device__ __forceinline__ int hi16(uint32_t w) { return (int16_t)(w >> 16); }
__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)b << 16);
}

// One B-sample-wide vertical line of the tile at s (its p side first):
// one 16-byte (luma) or 8-byte (chroma) shared-memory load and store.
template <int B>
__device__ __forceinline__ void ver_line(int16_t* s, const Cell& P, int bd) {
  int v[B];
  if constexpr (B == 8) {
    const uint4 w = *(const uint4*)s;
    const uint32_t a[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = lo16(a[k]);
      v[2 * k + 1] = hi16(a[k]);
    }
    if (line<B>(v, P, bd))
      *(uint4*)s = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                              pack2(v[4], v[5]), pack2(v[6], v[7]));
  } else {
    const uint2 w = *(const uint2*)s;
    v[0] = lo16(w.x), v[1] = hi16(w.x), v[2] = lo16(w.y), v[3] = hi16(w.y);
    if (line<B>(v, P, bd))
      *(uint2*)s = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
}

// Move the tile's words inside the area between the area and shared memory
// (`in`: load, else store); a word is SW = B / 2 samples, the shift of the
// block grid, so the tile's words are aligned wherever the area's base and
// pitch are (`wide`); else sample by sample.  A thread moves PER words,
// all its loads issued before its stores: one wait for device memory.
template <int B, typename Word>
__device__ __forceinline__ void move_tile(const Plane& P, int16_t* tile,
                                          int y0, int x0, bool in) {
  constexpr int SW = B / 2, WPR = TILE_W / SW;
  constexpr int PER = TILE_H * WPR / ADDB_THREADS;
  int16_t* g[PER];
  int16_t* s[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * ADDB_THREADS;
    const int r = i / WPR, w = i - r * WPR;
    const int y = y0 + r, x = x0 + w * SW;
    const bool inside = y >= 0 && y < P.H && x >= 0 && x < P.W;
    g[k] = inside ? P.area + (long)y * P.pitch + x : nullptr;
    s[k] = tile + r * TILE_W + w * SW;
  }
  if (P.wide) {
    Word v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (g[k]) v[k] = in ? *(const Word*)g[k] : *(const Word*)s[k];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (g[k]) *(Word*)(in ? s[k] : g[k]) = v[k];
  } else {
    int16_t v[PER][SW];
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int q = 0; q < SW; ++q)
        if (g[k]) v[k][q] = in ? g[k][q] : s[k][q];
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int q = 0; q < SW; ++q)
        if (g[k]) (in ? s[k] : g[k])[q] = v[k][q];
  }
}

// One tile of plane P: luma (B = 8) or chroma (B = 4) blocks.  A thread
// takes NV vertical lines (row, edge) and NH horizontal ones (edge,
// column); it loads their parameter cells first, so that their latency
// overlaps the tile's load and no pass waits on device memory.
template <int B, typename Word>
__device__ void addb_tile(const Plane& P, int t, int16_t* tile, int bd) {
  constexpr int H2 = B / 2, US = B == 8 ? 2 : 1;  // map cell: 1 << US samples
  constexpr int EPR = TILE_W / B, EPC = TILE_H / B;
  constexpr int NV = TILE_H * EPR / ADDB_THREADS;
  constexpr int NH = EPC * TILE_W / ADDB_THREADS;
  const int ty = t / P.tiles_x, tx = t - ty * P.tiles_x;
  const int y0 = ty * TILE_H - H2, x0 = tx * TILE_W - H2;
  const int hs = P.H >> US, ws = P.W >> US;
  const int ne_x = P.W / B - 1, ne_y = P.H / B - 1;   // edges 1 .. ne
  // vertical edges: block column c's edge at x = B c, rows of the tile;
  // horizontal edges: block row rr's edge at y = B rr, columns of the tile
  Cell cv[NV], ch[NH];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * ADDB_THREADS;
    const int r = i / EPR, e = i - r * EPR;
    const int y = y0 + r, c = tx * EPR + e;
    cv[k].bs = 0;
    if (y >= 0 && y < P.H && c >= 1 && c <= ne_x)
      cv[k] = load_cell(P.pars + ((long)(y >> US) * ws + 2 * c) * P.nch,
                        P.cb);
  }
  const int32_t* pars1 = P.pars + (long)hs * ws * P.nch;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const int i = threadIdx.x + k * ADDB_THREADS;
    const int e = i / TILE_W, col = i - e * TILE_W;
    const int x = x0 + col, rr = ty * EPC + e;
    ch[k].bs = 0;
    if (x >= 0 && x < P.W && rr >= 1 && rr <= ne_y)
      ch[k] = load_cell(pars1 + ((long)(2 * rr) * ws + (x >> US)) * P.nch,
                        P.cb);
  }
  move_tile<B, Word>(P, tile, y0, x0, true);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * ADDB_THREADS;
    const int r = i / EPR, e = i - r * EPR;
    if (cv[k].bs > 0) ver_line<B>(tile + r * TILE_W + e * B, cv[k], bd);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    if (ch[k].bs <= 0) continue;
    const int i = threadIdx.x + k * ADDB_THREADS;
    const int e = i / TILE_W, col = i - e * TILE_W;
    int16_t* s = tile + e * B * TILE_W + col;
    int v[B];
#pragma unroll
    for (int q = 0; q < B; ++q) v[q] = s[q * TILE_W];
    if (line<B>(v, ch[k], bd)) {
#pragma unroll
      for (int q = 1; q < B - 1; ++q) s[q * TILE_W] = (int16_t)v[q];
    }
  }
  __syncthreads();
  move_tile<B, Word>(P, tile, y0, x0, false);
}

__global__ void __launch_bounds__(ADDB_THREADS)
addb_frame_kernel(Plane y, Plane u, Plane v, int bd) {
  __shared__ __align__(16) int16_t tile[TILE_H * TILE_W];
  const int b = blockIdx.x;
  if (b < u.first)
    addb_tile<8, uint2>(y, b, tile, bd);
  else if (b < v.first)
    addb_tile<4, uint32_t>(u, b - u.first, tile, bd);
  else
    addb_tile<4, uint32_t>(v, b - v.first, tile, bd);
}

inline int tiles(int n, int B, int T) { return (n + B + T - 1) / T; }

inline Plane plane(void* area, int pitch, int H, int W, const void* pars,
                   int nch, int cb, int wide, int B, int first) {
  Plane p;
  p.area = (int16_t*)area;
  p.pars = (const int32_t*)pars;
  p.pitch = pitch, p.H = H, p.W = W, p.nch = nch, p.cb = cb;
  p.tiles_x = tiles(W, B, TILE_W);
  p.first = first;
  p.wide = wide;
  return p;
}

}  // namespace

// The luma area y [H, W] (pitch ypitch) with its map luma_pars [2, H/4,
// W/4, 4]; the chroma areas u, v [H/2, W/2] (pitches upitch, vpitch; both
// null for 4:0:0) with chroma_pars [2, H/4, W/4, 7].  `wide` bit 0, 1, 2:
// Y's, U's, V's base and pitch are aligned for word access.
extern "C" int xevd_addb_frame(void* y, int ypitch, void* u, int upitch,
                               void* v, int vpitch, int H, int W,
                               const void* luma_pars, const void* chroma_pars,
                               int wide, int bd, void* stream) {
  const int ny = tiles(H, 8, TILE_H) * tiles(W, 8, TILE_W);
  const int nc = u ? tiles(H >> 1, 4, TILE_H) * tiles(W >> 1, 4, TILE_W) : 0;
  const Plane py = plane(y, ypitch, H, W, luma_pars, 4, 1, wide & 1, 8, 0);
  const Plane pu = plane(u, upitch, H >> 1, W >> 1, chroma_pars, 7, 1,
                         (wide >> 1) & 1, 4, ny);
  const Plane pv = plane(v, vpitch, H >> 1, W >> 1, chroma_pars, 7, 4,
                         (wide >> 2) & 1, 4, ny + nc);
  if (H >= 8 && W >= 8)
    addb_frame_kernel<<<ny + 2 * nc, ADDB_THREADS, 0, (cudaStream_t)stream>>>(
        py, pu, pv, bd);
  return (int)cudaGetLastError();
}
