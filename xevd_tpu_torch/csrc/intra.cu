// Baseline intra reconstruction of a frame, or of the G frames of one time
// step of a GOP batch, in place on the bordered int16 picture planes.
//
// Replaces: xevd_tpu/ops/jax_intra.py `intra_scan` (K5; `_step_plane`,
// `_predict`), a lax.scan with one CU per step.  Semantics per CU and
// plane: up/left neighbours under per-unit availability masks (uint32
// bitfields, 4-px units for luma, 2-px for chroma, logical shifts), corner
// under its flag, unavailable samples = 1 << (bd - 1); the five Baseline
// predictors DC/HOR/VER/UL/UR (ref: src_base/xevd_ipred.c:95-676);
// pred + residual wrapped through int16, clipped to [0, 2^bd - 1], written
// over the cuw x cuw block.  Chroma uses the luma ipm with log2 - 1.
//
// Bound on the H100: latency.  A CU reads samples that earlier CUs wrote;
// each step is a few hundred bytes of neighbours and at most 64x64
// outputs.  The time is the chain of dependent CUs, not bandwidth or ALU.
//
// Design: a persistent scan that follows the true dependencies.  A CU
// reads only the 4x4 cells its masks name (up row and up-right, left
// column and below-left: unit u of either mask is one cell, in luma and in
// 4:2:0 chroma alike; the corner cell under its flag).  So:
// 1. intra_writer_kernel, one CTA a CU row: writes row index + 1 over the
//    cells of the row's block in its frame's writer map [G, hs, ws]
//    (zeroed by the wrapper: 0 = no writer in this scan -- MC and recon
//    wrote the cell before it, or nothing does).
// 2. intra_scan_kernel, a grid of the CTAs that fit on the card at once:
//    each CTA takes tickets (scan.cuh) and scans row n = order[ticket]
//    (the ticket itself for one frame: order NULL), stages the row's
//    residuals in shared memory (nothing in the scan writes them, so this
//    overlaps the wait), waits for the done flag of every row w < n that
//    wrote a cell its masks name, reconstructs luma, u and v in one pass
//    (neighbours staged in shared memory, DC sums by a warp a plane, then
//    the three blocks), and publishes its done flag.
//    The G frames of a batch step share the grid, their rows interleaved:
//    the pack's order (ops/pack.py `icu_order`) hands out the rows of all
//    frames by their depth in their frame's dependency DAG, so the
//    tickets in flight (about the grid's CTAs) are every frame's next
//    wavefront and a step costs about the longest of the frames' chains,
//    not their sum, as JAX's vmapped scan does.  In table order the
//    tickets in flight lie in one or two frames and the chains run one
//    after another; round-robin over the frames' rows cuts each frame's
//    share of the window to 1/G of the grid, too few rows to span a
//    frame's wavefront across CTU rows (measured by
//    tests/torch_scan_trace.py: PERF.md).
//    done[] and the waits stay in table rows, and frame g's rows look only
//    at frame g's map.
// The result equals decode order whenever every cell a mask names was
// written by an earlier row or before the scan, which every decoder table
// satisfies (ops/intra.py `intra_deps_ref` is the rule, and refuses a
// table that breaks it).  A row waits only on rows of its frame that are
// shallower in its DAG, which the order hands out first (a topological
// order of every frame's DAG), and a CTA running holds each ticket handed
// out, so the scan cannot deadlock.
#include <cuda_runtime.h>
#include <stdint.h>

#include "batch.cuh"
#include "scan.cuh"

#define BORDER 72
#define SCAN_THREADS 256
#define WRITER_THREADS 128

// Built with -DXEVD_INTRA_TRACE (tests/torch_scan_trace.py, never the
// port's library): thread 0 of the CTA that scans row n writes the
// %globaltimer (ns) when it took the row's ticket to trace[2 n] and when
// it published the row's done flag to trace[2 n + 1].
#ifdef XEVD_INTRA_TRACE
__device__ unsigned long long* g_intra_trace;
#define TRACE_AT(n, k)                                                    \
  do {                                                                    \
    if (threadIdx.x == 0 && g_intra_trace) {                              \
      unsigned long long t_;                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      g_intra_trace[2 * (size_t)(n) + (k)] = t_;                          \
    }                                                                     \
  } while (0)
#else
#define TRACE_AT(n, k) \
  do {                 \
  } while (0)
#endif

namespace {

// CU row: x, y, log2, ipm, up_mask, left_mask, corner, valid
__global__ void __launch_bounds__(WRITER_THREADS)
intra_writer_kernel(const int32_t* __restrict__ icu,
                    const int32_t* __restrict__ icu_off, int G,
                    int32_t* __restrict__ wmap, int hs, int ws) {
  const int n = blockIdx.x;
  const int32_t* c = icu + (size_t)n * 8;
  if (c[7] != 1) return;
  const int sw = c[2] > 2 ? 1 << (c[2] - 2) : 1;
  const int xs = c[0] >> 2, ys = c[1] >> 2;
  int32_t* m = wmap + (size_t)batch_of(icu_off, G, n) * hs * ws;
  for (int i = threadIdx.x; i < sw * sw; i += blockDim.x) {
    const int cy = ys + i / sw, cx = xs + i % sw;
    if (cy >= 0 && cy < hs && cx >= 0 && cx < ws) m[cy * ws + cx] = n + 1;
  }
}

struct Plane {
  int16_t* base;         // the block's top-left sample
  const int16_t* rbase;  // its residual
  int stride, log2, unit;
};

// The CU's three blocks: luma, then u and v (4:2:0).
struct Cu {
  int16_t *y, *u, *v;           // the blocks' top-left samples
  const int16_t *ry, *ru, *rv;  // their residuals
  int sy, sc, lg;               // strides, luma log2 size
};

// Plane p of the CU, chosen by selects: an array of planes indexed at run
// time would live in local memory.
__device__ __forceinline__ Plane plane_of(const Cu& cu, int p) {
  Plane q;
  q.base = p == 0 ? cu.y : (p == 1 ? cu.u : cu.v);
  q.rbase = p == 0 ? cu.ry : (p == 1 ? cu.ru : cu.rv);
  q.stride = p == 0 ? cu.sy : cu.sc;
  q.log2 = p == 0 ? cu.lg : cu.lg - 1;
  q.unit = p == 0 ? 4 : 2;
  return q;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One valid CU row n of frame g: wait for its writers, then luma, u, v.
// Every argument is uniform over the CTA.
__device__ __forceinline__ void scan_cu(
    const int32_t* c, int n, const Cu& cu, int np, int bd,
    const int32_t* __restrict__ fmap, int hs, int ws, const int* done,
    int (*s_up)[128], int (*s_le)[128], int* s_cor, int* s_dc,
    int16_t* s_res) {
  const int t = threadIdx.x;
  const int ipm = c[3];
  const uint32_t upm = (uint32_t)c[4], lem = (uint32_t)c[5];
  const int cor = c[6];
  const int xs = c[0] >> 2, ys = c[1] >> 2;
  const int nu = 2 * (1 << (cu.lg - 2));     // units along each mask
  const int a0 = 1 << (2 * cu.lg);                          // luma samples
  const int a1 = np > 1 ? 1 << (2 * cu.lg - 2) : 0;         // a chroma block

  // the residuals, before the wait (nothing in the scan writes them)
  for (int i = t; i < a0 + 2 * a1; i += blockDim.x) {
    const int p = i < a0 ? 0 : (i < a0 + a1 ? 1 : 2);
    const int j = p == 0 ? i : i - a0 - (p - 1) * a1;
    const Plane q = plane_of(cu, p);
    s_res[i] = __ldg(q.rbase + (long)(j >> q.log2) * q.stride +
                     (j & ((1 << q.log2) - 1)));
  }

  // the writers of the cells the masks name, one thread a cell
  if (t <= 2 * nu) {
    int cy = ys - 1, cx = xs - 1;
    bool on = cor == 1;
    if (t < nu) {
      on = (upm >> t) & 1u;
      cx = xs + t;
    } else if (t < 2 * nu) {
      on = (lem >> (t - nu)) & 1u;
      cy = ys + t - nu;
    }
    if (on && cy >= 0 && cy < hs && cx >= 0 && cx < ws) {
      const int w = fmap[cy * ws + cx] - 1;
      if (w >= 0 && w < n) wait_at_least(done + w, 1);
    }
  }
  __syncthreads();

  // neighbours of every plane: [p][0..n2) up, left
  const int mid = 1 << (bd - 1);
  for (int i = t; i < np * 256; i += blockDim.x) {
    const Plane q = plane_of(cu, i >> 8);
    const int k = i & 127, n2 = 2 << q.log2;
    if (k >= n2) continue;
    const uint32_t u = (uint32_t)(k / q.unit);
    if (i & 128)
      s_le[i >> 8][k] = ((lem >> u) & 1u)
                            ? (int)__ldcg(q.base + (long)k * q.stride - 1)
                            : mid;
    else
      s_up[i >> 8][k] =
          ((upm >> u) & 1u) ? (int)__ldcg(q.base + k - q.stride) : mid;
  }
  if (t < np) {
    const Plane q = plane_of(cu, t);
    s_cor[t] = cor == 1 ? (int)__ldcg(q.base - q.stride - 1) : mid;
  }
  __syncthreads();
  if (ipm == 0 && (t >> 5) < np) {  // DC: warp p sums plane p
    const int p = t >> 5, lg = p == 0 ? cu.lg : cu.lg - 1, cuw = 1 << lg;
    int s = 0;
    for (int k = t & 31; k < cuw; k += 32) s += s_up[p][k] + s_le[p][k];
    s = warp_sum(s);
    if ((t & 31) == 0) s_dc[p] = (s + cuw) >> (lg + 1);
  }
  __syncthreads();

  const int maxv = (1 << bd) - 1;
  for (int i = t; i < a0 + 2 * a1; i += blockDim.x) {
    const int p = i < a0 ? 0 : (i < a0 + a1 ? 1 : 2);
    const int j = p == 0 ? i : i - a0 - (p - 1) * a1;
    const Plane q = plane_of(cu, p);
    const int ii = j >> q.log2, jj = j & ((1 << q.log2) - 1);
    const int* up = s_up[p];
    const int* le = s_le[p];
    int pred;
    if (ipm == 2) {
      pred = up[jj];                                     // VER
    } else if (ipm == 1) {
      pred = le[ii];                                     // HOR
    } else if (ipm == 0) {
      pred = s_dc[p];                                    // DC
    } else if (ipm == 3) {                               // UL
      const int d = ii - jj;
      pred = d > 0 ? le[d - 1] : (d == 0 ? s_cor[p] : up[-d - 1]);
    } else {                                             // UR
      const int k = ii + jj + 1;
      pred = (up[k] + le[k]) >> 1;
    }
    int v = (int16_t)(pred + (int)s_res[i]);
    v = v < 0 ? 0 : (v > maxv ? maxv : v);
    q.base[(long)ii * q.stride + jj] = (int16_t)v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SCAN_THREADS)
intra_scan_kernel(int16_t* rec_y, int16_t* rec_u, int16_t* rec_v,
                  const int16_t* res_y, const int16_t* res_u,
                  const int16_t* res_v, int stride_y, int stride_c,
                  const int32_t* __restrict__ icu, int n_cu, int bd,
                  int chroma, const int32_t* __restrict__ icu_off,
                  const int32_t* __restrict__ order, int G,
                  long long bs_y, long long bs_c,
                  const int32_t* __restrict__ wmap, int hs, int ws,
                  int* ticket, int* done) {
  __shared__ int s_up[3][128], s_le[3][128], s_cor[3], s_dc[3], s_n[2];
  __shared__ int16_t s_res[64 * 64 + 2 * 32 * 32];
  for (int it = 0;; ++it) {
    const int k = take_ticket(ticket, s_n, it);
    if (k >= n_cu) return;
    const int n = order ? __ldg(order + k) : k;
    TRACE_AT(n, 0);
    const int32_t* c = icu + (size_t)n * 8;
    if (c[7] == 1) {
      const long long g = batch_of(icu_off, G, n);
      const int x = c[0], y = c[1], lg = c[2];
      const long oy = (long)(BORDER + y) * stride_y + BORDER + x;
      const long oc = (long)(BORDER + (y >> 1)) * stride_c + BORDER +
                      (x >> 1);
      const long long gc = chroma ? g * bs_c + oc : 0;
      const Cu cu = {rec_y + g * bs_y + oy, rec_u + gc, rec_v + gc,
                     res_y + g * bs_y + oy, res_u + gc, res_v + gc,
                     stride_y, stride_c, lg};
      scan_cu(c, n, cu, chroma ? 3 : 1, bd, wmap + g * hs * ws, hs, ws, done,
              s_up, s_le, s_cor, s_dc, s_res);
    }
    if (threadIdx.x == 0) st_release(done + n, 1);
    TRACE_AT(n, 1);
  }
}

}  // namespace

// The persistent grid of the scan kernel: the CTAs that fit on the current
// device at once (one launch uses min(this, rows)).
extern "C" int xevd_intra_scan_grid(int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intra_scan_kernel,
                                                SCAN_THREADS, 0);
  *grid = sms * per_sm;
  return (int)cudaGetLastError();
}

#ifdef XEVD_INTRA_TRACE
// trace: device uint64 [2 n_cu] for the next scans, or NULL.
extern "C" int xevd_intra_trace_set(void* trace) {
  return (int)cudaMemcpyToSymbol(g_intra_trace, &trace, sizeof(trace));
}
#endif

// icu_off: device int32 [G + 1], or NULL for one frame (G 1); order:
// device int32 [n_cu], ticket -> table row, a topological order of every
// frame's dependency DAG (ops/pack.py `icu_order`), or NULL for table
// order; bs_y, bs_c: the batch strides of the luma and chroma planes, in
// elements; scratch: device int32 [1 + n_cu + G * hs * ws], zeroed: the
// ticket counter, the rows' done flags, the writer maps over hs x ws
// cells.
extern "C" int xevd_intra_scan(void* rec_y, void* rec_u, void* rec_v,
                               const void* res_y, const void* res_u,
                               const void* res_v, int stride_y, int stride_c,
                               const void* icu, int n_cu, int bd, int chroma,
                               const void* icu_off, const void* order, int G,
                               long long bs_y, long long bs_c, void* scratch,
                               int hs, int ws, void* stream) {
  if (n_cu <= 0 || G <= 0) return (int)cudaGetLastError();
  int grid = 0;
  int err = xevd_intra_scan_grid(&grid);
  if (err != cudaSuccess) return err;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  int* ticket = (int*)scratch;
  int* done = ticket + 1;
  int32_t* wmap = done + n_cu;
  intra_writer_kernel<<<n_cu, WRITER_THREADS, 0, s>>>(
      (const int32_t*)icu, (const int32_t*)icu_off, G, wmap, hs, ws);
  err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  intra_scan_kernel<<<grid < n_cu ? grid : n_cu, SCAN_THREADS, 0, s>>>(
      (int16_t*)rec_y, (int16_t*)rec_u, (int16_t*)rec_v,
      (const int16_t*)res_y, (const int16_t*)res_u, (const int16_t*)res_v,
      stride_y, stride_c, (const int32_t*)icu, n_cu, bd, chroma,
      (const int32_t*)icu_off, (const int32_t*)order, G, bs_y, bs_c, wmap,
      hs, ws, ticket, done);
  return (int)cudaGetLastError();
}
