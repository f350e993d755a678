// Baseline deblocking passes, in place on the SCU-cropped picture area.
//
// Replaces: xevd_tpu/ops/jax_deblock.py `luma_ver_pass`, `luma_hor_pass`
// (K8, `_luma_filter`), `chroma_ver_pass`, `chroma_hor_pass` (K9,
// `_chroma_filter`; ref: src_base/xevd_df.c:96-195) and `chroma_ver_ordered`
// (K10, the SUCO-order chroma vertical edges).  The function that runs
// them in reference order (luma ver, chroma ver, luma hor, chroma hor) is
// xevd_tpu_torch/ops/deblock.py `deblock_frame` (K12).
//
// Bound on the H100: memory.  Each pass reads and writes at most 4 samples
// per edge position, a few bytes per pixel of the plane, and does a dozen
// integer operations per edge; there is no reuse.
//
// Design: the kernels read the per-SCU strength map themselves
// (st[r >> 2] luma, st[r >> 1] chroma) instead of materialising the
// repeated maps of the JAX version.  Luma edges are 4 px apart and reach
// +-2 px, so one thread per (line, edge) filters all edges at once.
// Chroma edges are 2 px apart and cascade (edge e reads the sample edge
// e - 1 wrote), so one thread per line walks its edges in order, reading
// and writing the plane in place -- the in-place walk is exactly the
// lax.scan carry of the JAX version.  Division is C truncating division
// (`_div_trunc`), not an arithmetic shift.
//
// K10: under SUCO a row's chroma edges cascade in the order of the per-CU
// deblock visit, not left to right.  The JAX version scans waves of at
// most one edge per SCU row; here the host ships each SCU row's edges in
// that order (ops/pack.py `chroma_ver_edges`, a CSR table), and one
// thread per chroma line and plane walks its row's list -- one launch a
// frame, no waves.  Its dependency chain is the longest row's edge count.
#include <cuda_runtime.h>
#include <stdint.h>

#define DB_THREADS 256

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

// p points at C (first sample past the edge); `step` is the distance
// between samples across the edge (1 vertical edge, stride horizontal edge)
__device__ __forceinline__ void luma_edge(int16_t* p, long step, int st,
                                          int maxv) {
  const int A = p[-2 * step], B = p[-step], C = p[0], D = p[step];
  int clip;
  const int d1 = edge_delta(A, B, C, D, st, &clip);
  const int clip2 = clip >> 1;
  const int d2 = clampi(div_trunc(A - D, 2), -clip2, clip2);
  p[-2 * step] = (int16_t)clampi(A - d2, 0, maxv);
  p[-step] = (int16_t)clampi(B + d1, 0, maxv);
  p[0] = (int16_t)clampi(C - d1, 0, maxv);
  p[step] = (int16_t)clampi(D + d2, 0, maxv);
}

__device__ __forceinline__ void chroma_edge(int16_t* p, long step, int st,
                                            int maxv) {
  const int A = p[-2 * step], B = p[-step], C = p[0], D = p[step];
  int clip;
  const int d1 = edge_delta(A, B, C, D, st, &clip);
  p[-step] = (int16_t)clampi(B + d1, 0, maxv);
  p[0] = (int16_t)clampi(C - d1, 0, maxv);
}

// area [H, W] with row pitch `stride`; st [H/4, W/4]: strength of the
// vertical edge left of each 4x4 (0 = none).  Thread per (row, edge).
__global__ void luma_ver_kernel(int16_t* area, int stride, int H, int W,
                                const int32_t* __restrict__ st, int maxv) {
  const int ws = W >> 2, ne = ws - 1;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ne <= 0 || idx >= (long)H * ne) return;
  const int r = (int)(idx / ne), e = (int)(idx % ne) + 1;
  const int s = st[(r >> 2) * ws + e];
  if (s > 0) luma_edge(area + (long)r * stride + 4 * e, 1, s, maxv);
}

// st [H/4, W/4]: strength of the horizontal edge above each 4x4.
// Thread per (edge, column).
__global__ void luma_hor_kernel(int16_t* area, int stride, int H, int W,
                                const int32_t* __restrict__ st, int maxv) {
  const int ws = W >> 2, ne = (H >> 2) - 1;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ne <= 0 || idx >= (long)ne * W) return;
  const int e = (int)(idx / W) + 1, c = (int)(idx % W);
  const int s = st[e * ws + (c >> 2)];
  if (s > 0) luma_edge(area + (long)(4 * e) * stride + c, stride, s, maxv);
}

// chroma area [H, W]; st [H/2, W/2] per SCU.  Thread per row, walking the
// vertical edges at x = 2, 4, ... left to right.
__global__ void chroma_ver_kernel(int16_t* area, int stride, int H, int W,
                                  const int32_t* __restrict__ st, int maxv) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= H) return;
  const int ws = W >> 1;
  int16_t* row = area + (long)r * stride;
  const int32_t* srow = st + (r >> 1) * ws;
  for (int e = 1; e < ws; ++e) {
    const int s = srow[e];
    if (s > 0) chroma_edge(row + 2 * e, 1, s, maxv);
  }
}

// Thread per column, walking the horizontal edges at y = 2, 4, ... top to
// bottom.
__global__ void chroma_hor_kernel(int16_t* area, int stride, int H, int W,
                                  const int32_t* __restrict__ st, int maxv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  const int ws = W >> 1, ne = H >> 1;
  for (int e = 1; e < ne; ++e) {
    const int s = st[e * ws + (c >> 1)];
    if (s > 0) chroma_edge(area + (long)(2 * e) * stride + c, stride, s, maxv);
  }
}

// K10: u, v [H, W] (H = 2 h_scu), one row pitch; row_off [h_scu + 1] and
// edges [E, 3] = (x, st_u, st_v), each SCU row's edges in filter order.
// Thread per (plane, line): the two lines of an SCU row see the same
// edges; the pack checks 2 <= x <= W - 2.
__global__ void chroma_ver_ordered_kernel(int16_t* u, int16_t* v, int stride,
                                          int H,
                                          const int32_t* __restrict__ row_off,
                                          const int32_t* __restrict__ edges,
                                          int maxv) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * H) return;
  const int plane = idx >= H, r = idx - plane * H;
  int16_t* row = (plane ? v : u) + (long)r * stride;
  const int e1 = row_off[(r >> 1) + 1];
  for (int e = row_off[r >> 1]; e < e1; ++e) {
    const int s = edges[3 * e + 1 + plane];
    if (s > 0) chroma_edge(row + edges[3 * e], 1, s, maxv);
  }
}

inline int blocks(long n) { return (int)((n + DB_THREADS - 1) / DB_THREADS); }

}  // namespace

extern "C" int xevd_deblock_luma_ver(void* area, int stride, int H, int W,
                                     const void* st, int bd, void* stream) {
  const long n = (long)H * ((W >> 2) - 1);
  if (n > 0)
    luma_ver_kernel<<<blocks(n), DB_THREADS, 0, (cudaStream_t)stream>>>(
        (int16_t*)area, stride, H, W, (const int32_t*)st, (1 << bd) - 1);
  return (int)cudaGetLastError();
}

extern "C" int xevd_deblock_luma_hor(void* area, int stride, int H, int W,
                                     const void* st, int bd, void* stream) {
  const long n = (long)((H >> 2) - 1) * W;
  if (n > 0)
    luma_hor_kernel<<<blocks(n), DB_THREADS, 0, (cudaStream_t)stream>>>(
        (int16_t*)area, stride, H, W, (const int32_t*)st, (1 << bd) - 1);
  return (int)cudaGetLastError();
}

extern "C" int xevd_deblock_chroma_ver(void* area, int stride, int H, int W,
                                       const void* st, int bd, void* stream) {
  if (H > 0)
    chroma_ver_kernel<<<blocks(H), DB_THREADS, 0, (cudaStream_t)stream>>>(
        (int16_t*)area, stride, H, W, (const int32_t*)st, (1 << bd) - 1);
  return (int)cudaGetLastError();
}

extern "C" int xevd_deblock_chroma_hor(void* area, int stride, int H, int W,
                                       const void* st, int bd, void* stream) {
  if (W > 0)
    chroma_hor_kernel<<<blocks(W), DB_THREADS, 0, (cudaStream_t)stream>>>(
        (int16_t*)area, stride, H, W, (const int32_t*)st, (1 << bd) - 1);
  return (int)cudaGetLastError();
}

extern "C" int xevd_chroma_ver_ordered(void* u, void* v, int stride, int H,
                                       const void* row_off, const void* edges,
                                       int bd, void* stream) {
  if (H > 0)
    chroma_ver_ordered_kernel<<<blocks(2L * H), DB_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (int16_t*)u, (int16_t*)v, stride, H, (const int32_t*)row_off,
        (const int32_t*)edges, (1 << bd) - 1);
  return (int)cudaGetLastError();
}
