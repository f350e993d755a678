// Fractional-pel motion compensation of every inter block of one reference
// list, added into the int32 prediction planes, with the count planes.
//
// Replaces: xevd_tpu/ops/jax_mc.py `mc_bucket` (K3: window gather
// `_gather_windows`, separable taps `_hfilter` / `_vfilter`) fused with
// xevd_tpu/ops/pipeline.py `_mc_all` (K4: scatter-add of the predictions
// and of the count plane).  Arithmetic follows ops/ref_numpy.py `mc_luma` /
// `mc_chroma` exactly: luma 8 taps at 1/16 pel, chroma 4 taps at 1/32 pel;
// case 00 copies, N0 and 0N clip (acc >> 6) with no rounding offset, NN
// truncates its horizontal pass (>> shift1) to int16, a wrap, then rounds
// with offset2.  The case comes from the table, never from the phase: a
// clipped MV can have phase 0 under a filtering case, and tap row 0 runs.
//
// Bound on the H100: the shape of the work and the writes, not the
// arithmetic.  A 1080p picture reads about 4 MB of reference windows and
// writes 14 MB of prediction and count planes a list (0.005 ms at 3.35
// TB/s); its 8 or 4 multiply-adds a sample and pass are a few us of the
// SMs' int32 rate.  What costs is tens of thousands of blocks, most of
// them 4 to 16 a side: one CTA a block (the design before this one) left
// 240 of 256 threads of a 4x4 block idle, and each CTA's window staging,
// barriers and plane round trips were one wave of the card's 8 CTAs an
// SM.  With that gone, the scattered stores remain the largest cost: a
// 4-wide block writes each row as its own 16-byte request (PERF.md).
// Tensor cores do not fit: samples go up to 10 bits in int16 planes and
// every product must be an exact int32.
//
// Design: one launch per reference list over the list's rows grouped by
// frame and class (plane, log2 w, log2 h, filter case: at most 200), a
// counting sort on the host (ops/pack.py `mc_order`; the table keeps its
// order).  `order` lists (table row, frame g) class by class, and
// `classes` gives each (frame, class) its first CTA in the launch, first
// order entry, block count and shape.  A thread owns a tile of Q =
// min(w, 4) columns by R rows of one block, R = min(h, 8), or min(h, 4)
// where the list's launch then fits the card at once (a launch of one
// partial wave lasts one thread's chain of rows); a block takes w h / (Q
// R) threads, and a 256-thread CTA holds 256 / that many blocks of its
// class (two 64x64 blocks at R = 8, or 256 4x4 luma blocks), so the
// largest blocks are split by rows and column quads over threads and the
// smallest share a CTA.  Every thread works alone: no shared memory,
// no barrier, no atomics.  It walks its window rows (R, plus 7 or 3 under
// vertical taps) in a loop: each row straight into registers with 32-bit
// loads of the aligned words that cover its Q columns (plus 7 or 3 under
// horizontal taps; adjacent threads read adjacent quads, so a warp's
// loads coalesce where a block is wide and the overlap between tiles hits
// L1), filtered horizontally into the newest of NTAP rows of results kept
// in registers, and from the NTAP-th row on one output row by the
// vertical taps, written with one vector store where aligned.  The case,
// Q and the tap count are template arguments (12 shapes), so no loop
// divides or branches on the shape; the loop body is not unrolled over
// rows, which keeps the kernel small (a fully unrolled R x Q tile in
// registers measured no faster, PERF.md).  Frame-major order
// keeps a GOP batch's CTAs in flight on one frame's planes at a time, so
// its scattered writes complete their sectors in L2.  A chroma thread does
// u then v with the same position and taps.  Within one list the blocks
// tile disjoint parts of the picture, so a thread owns its outputs: the
// first launch of a call stores (the planes are zero), the second adds,
// each without atomics, and the result is deterministic.  A frame's
// reference planes come as a pointer table in the kernel's parameters
// (one pitch per plane group), so no plane is stacked or copied; a frame
// has at most MAX_SLOTS references (ops/pack.py refuses more).  Every
// reference plane is 4-byte aligned with an even pitch (the wrapper
// checks), so a word never straddles two rows.
//
// GOP batch (K15): the table of one list holds the blocks of the G frames
// of one time step; each order entry carries its frame g, whose prediction
// and count planes lie g times their batch stride from the first.  Its
// references are the DPB ring of the batch, one tensor [D, G_dev, H, W] a
// plane (xevd_tpu_torch/parallel/gop.py): slot s = (d - 1) * G_dev + g is
// GOP g's picture d steps back from step t, ring entry ((t - d) mod D,
// g), which a thread addresses by the ring's strides.  So the batch takes
// any D x G_dev, as JAX's step does.  One launch a list and step.
#include <cuda_runtime.h>
#include <stdint.h>

#define MC_THREADS 256
#define MC_LOG2_THREADS 8
#define MAX_SLOTS 32

namespace {

// A frame's references: a pointer a slot and plane (u, v NULL for 4:0:0).
struct SlotTable {
  const int16_t* y[MAX_SLOTS];
  const int16_t* u[MAX_SLOTS];
  const int16_t* v[MAX_SLOTS];
  __device__ __forceinline__ void get(int s, const int16_t*& py,
                                      const int16_t*& pu,
                                      const int16_t*& pv) const {
    py = y[s];
    pu = u[s];
    pv = v[s];
  }
};

// A GOP batch's DPB ring: plane p's picture (i, g) at p + i * sd + g * sg
// (elements; sd_c, sg_c for u and v); slot s is ring entry
// ((t - d) mod D, g) with d = s / Gd + 1, g = s mod Gd (once a thread).
struct Ring {
  const int16_t *y, *u, *v;
  long long sd_y, sg_y, sd_c, sg_c;
  int D, Gd, t;
  __device__ __forceinline__ void get(int s, const int16_t*& py,
                                      const int16_t*& pu,
                                      const int16_t*& pv) const {
    const int d = s / Gd + 1, g = s - (d - 1) * Gd;
    const long long i = ((t - d) % D + D) % D;
    py = y + i * sd_y + g * sg_y;
    pu = u ? u + i * sd_c + g * sg_c : nullptr;
    pv = v ? v + i * sd_c + g * sg_c : nullptr;
  }
};

// The NS int16 samples p[0 .. NS - 1] of a reference row, sign-extended:
// 32-bit loads of the aligned words that cover them, split by funnel
// shifts.  A word that holds no needed sample is not loaded (the one past
// an even count from an even start), so every load stays in the row.
template <int NS>
__device__ __forceinline__ void load_row(const int16_t* p, int (&s)[NS]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned odd = (unsigned)(a >> 1) & 1u;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  constexpr int NW = NS / 2 + 1;
  uint32_t v[NW];
#pragma unroll
  for (int j = 0; j < NW - 1; ++j) v[j] = __ldg(w + j);
  v[NW - 1] = ((NS & 1) || odd) ? __ldg(w + NW - 1) : 0u;
#pragma unroll
  for (int k = 0; k < NS; k += 2) {
    const int j = k >> 1;
    const uint32_t f = __funnelshift_r(v[j], j + 1 < NW ? v[j + 1] : v[j],
                                       16 * odd);
    s[k] = (int)(int16_t)(f & 0xffffu);
    if (k + 1 < NS) s[k + 1] = (int)f >> 16;
  }
}

__device__ __forceinline__ int clip(int v, int maxv) {
  return v < 0 ? 0 : (v > maxv ? maxv : v);
}

// Q consecutive outputs of one row into the prediction plane (added when
// `add`, else stored) and, when cnt is not NULL, one into each of their
// counts: one vector access where aligned, else one a sample.
template <int Q>
__device__ __forceinline__ void put(int32_t* pred, int8_t* cnt,
                                    const int (&v)[Q], bool add) {
  if (Q == 4 && (reinterpret_cast<uintptr_t>(pred) & 15) == 0) {
    int4* p4 = reinterpret_cast<int4*>(pred);
    int4 o = make_int4(v[0], v[1], v[Q > 2 ? 2 : 0], v[Q > 3 ? 3 : 0]);
    if (add) {
      const int4 c = *p4;
      o.x += c.x;
      o.y += c.y;
      o.z += c.z;
      o.w += c.w;
    }
    *p4 = o;
  } else if (Q == 2 && (reinterpret_cast<uintptr_t>(pred) & 7) == 0) {
    int2* p2 = reinterpret_cast<int2*>(pred);
    int2 o = make_int2(v[0], v[1]);
    if (add) {
      const int2 c = *p2;
      o.x += c.x;
      o.y += c.y;
    }
    *p2 = o;
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) pred[q] = add ? pred[q] + v[q] : v[q];
  }
  if (cnt == nullptr) return;
  // counts are 0, 1 or 2: a byte-lane add never carries
  if (Q == 4 && (reinterpret_cast<uintptr_t>(cnt) & 3) == 0) {
    uint32_t* c4 = reinterpret_cast<uint32_t*>(cnt);
    *c4 = add ? *c4 + 0x01010101u : 0x01010101u;
  } else if (Q == 2 && (reinterpret_cast<uintptr_t>(cnt) & 1) == 0) {
    uint16_t* c2 = reinterpret_cast<uint16_t*>(cnt);
    *c2 = add ? (uint16_t)(*c2 + 0x0101u) : (uint16_t)0x0101u;
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) cnt[q] = add ? (int8_t)(cnt[q] + 1) : 1;
  }
}

// One thread's tile of one plane: the R x Q outputs at (y0 .. y0 + R - 1,
// x0 .. x0 + Q - 1) of its block, from the window whose first sample
// (taps' half widths included) is p, into pred (and cnt) at those rows.
// A loop over the window rows, not unrolled (one copy of its body a
// class shape keeps the kernel's code small): each row is loaded once
// and filtered horizontally (CS & 1) into the newest of the NTAP rows of
// horizontal results kept in registers, and each row from the NTAP-th on
// completes one output row by the vertical taps (CS & 2).
template <int NTAP, int CS, int Q>
__device__ __forceinline__ void mc_tile(const int16_t* p, int pitch, int R,
                                        const int (&tx)[NTAP],
                                        const int (&ty)[NTAP], int bd,
                                        int32_t* pred, int8_t* cnt, int ps,
                                        bool add) {
  constexpr bool HX = CS & 1, VY = (CS & 2) != 0;
  constexpr int NS = Q + (HX ? NTAP - 1 : 0);
  constexpr int NV = VY ? NTAP : 1;
  const int maxv = (1 << bd) - 1;
  const int shift1 = bd - 8 < 4 ? bd - 8 : 4;
  const int shift2 = 20 - bd > 8 ? 20 - bd : 8;
  const int rnd = CS == 3 ? 1 << (shift2 - 1) : 0;
  const int sh = CS == 3 ? shift2 : 6;
  int h[NV][Q] = {};
#pragma unroll 1
  for (int r = 0; r < R + NV - 1; ++r) {
    int s[NS];
    load_row<NS>(p + r * pitch, s);
#pragma unroll
    for (int k = 0; k + 1 < NV; ++k)
#pragma unroll
      for (int q = 0; q < Q; ++q) h[k][q] = h[k + 1][q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int hv = s[q];
      if (HX) {
        int a = 0;
#pragma unroll
        for (int k = 0; k < NTAP; ++k) a += tx[k] * s[q + k];
        hv = CS == 3 ? (int)(int16_t)(a >> shift1) : a;
      }
      h[NV - 1][q] = hv;
    }
    if (r >= NV - 1) {
      int v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (VY) {
          int a = 0;
#pragma unroll
          for (int k = 0; k < NTAP; ++k) a += ty[k] * h[k][q];
          v[q] = clip((a + rnd) >> sh, maxv);
        } else {
          v[q] = HX ? clip(h[0][q] >> 6, maxv) : h[0][q];
        }
      }
      const int y = r - (NV - 1);
      put<Q>(pred + y * ps, cnt ? cnt + y * ps : nullptr, v, add);
    }
  }
}

// NTAP consecutive int32 taps of one phase (a 32- or 16-byte table row)
template <int NTAP>
__device__ __forceinline__ void load_taps(const int32_t* row,
                                          int (&t)[NTAP]) {
#pragma unroll
  for (int k = 0; k < NTAP; k += 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row + k));
    t[k] = v.x;
    t[k + 1] = v.y;
    t[k + 2] = v.z;
    t[k + 3] = v.w;
  }
}

// A thread's tile (x0, y0), Q columns by R rows, of one block and plane
// group: luma (NTAP 8, FBITS 4) into pred0 / cnt, or chroma (NTAP 4,
// FBITS 5) u from ref0 into pred0 / cnt, then v from ref1 into pred1.
template <int NTAP, int FBITS, int CS, int Q>
__device__ __forceinline__ void mc_block_tile(
    const int16_t* ref0, const int16_t* ref1, int pitch, int32_t* pred0,
    int32_t* pred1, int8_t* cnt, int ps, const int32_t* __restrict__ taps,
    int gx, int gy, int py, int px, int x0, int y0, int R, int bd,
    bool add) {
  constexpr int HALF = NTAP / 2 - 1;
  constexpr int FMASK = (1 << FBITS) - 1;
  int tx[NTAP] = {}, ty[NTAP] = {};
  if (CS & 1) load_taps<NTAP>(taps + (gx & FMASK) * NTAP, tx);
  if (CS & 2) load_taps<NTAP>(taps + (gy & FMASK) * NTAP, ty);
  const int ix = (gx >> FBITS) - ((CS & 1) ? HALF : 0) + x0;
  const int iy = (gy >> FBITS) - ((CS & 2) ? HALF : 0) + y0;
  const long long win = (long long)iy * pitch + ix;
  const long long o = (long long)(py + y0) * ps + px + x0;
  mc_tile<NTAP, CS, Q>(ref0 + win, pitch, R, tx, ty, bd, pred0 + o, cnt + o,
                       ps, add);
  if (ref1 != nullptr)
    mc_tile<NTAP, CS, Q>(ref1 + win, pitch, R, tx, ty, bd, pred1 + o,
                         nullptr, ps, add);
}

// MC table row: plane, w, h, case, slot, gx, gy, py, px, list.  Class
// shape: (plane << 13) | (log2 Q << 11) | (log2 R << 8) | (log2 w << 5) |
// (log2 h << 2) | case (ops/pack.py `mc_order`).
template <class Refs>
__global__ void __launch_bounds__(MC_THREADS, 3)
mc_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ order,
          const int32_t* __restrict__ classes, int n_cls, Refs refs,
          int pitch_y, int pitch_c, int32_t* pred_y, int32_t* pred_u,
          int32_t* pred_v, int8_t* cnt_y, int8_t* cnt_c, int ps_y, int ps_c,
          const int32_t* __restrict__ taps_l,
          const int32_t* __restrict__ taps_c, int bd, int add,
          long long pbs_y, long long pbs_c) {
  // this CTA's class: the last with first CTA <= blockIdx.x
  int lo = 0, hi = n_cls - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(classes + mid * 4) <= (int)blockIdx.x)
      lo = mid;
    else
      hi = mid - 1;
  }
  // (the tables are views into the frame's int32 payload: 4-byte aligned)
  const int cta0 = __ldg(classes + lo * 4), ord0 = __ldg(classes + lo * 4 + 1);
  const int count = __ldg(classes + lo * 4 + 2);
  const int shape = __ldg(classes + lo * 4 + 3);
  const int lh = (shape >> 2) & 7, lw = (shape >> 5) & 7;
  const int lr = (shape >> 8) & 7, lq = (shape >> 11) & 3;
  const int lbx = lw - lq;                       // log2 tiles a block row
  const int lt = lbx + lh - lr;                  // log2 threads a block
  const int b = (((int)blockIdx.x - cta0) << (MC_LOG2_THREADS - lt)) +
                ((int)threadIdx.x >> lt);        // the block in its class
  if (b >= count) return;
  const int tile = threadIdx.x & ((1 << lt) - 1);
  const int x0 = (tile & ((1 << lbx) - 1)) << lq, y0 = (tile >> lbx) << lr;
  const int32_t* og = order + (size_t)(ord0 + b) * 2;
  const int32_t* r = rows + (size_t)__ldg(og) * 10;
  const int slot = __ldg(r + 4), gx = __ldg(r + 5), gy = __ldg(r + 6);
  const int py = __ldg(r + 7), px = __ldg(r + 8);
  const long long g = __ldg(og + 1);
  const int16_t *ry, *ru, *rv;
  refs.get(slot, ry, ru, rv);
  const bool accumulate = add != 0;
  // one instance a (plane, case, Q) that ops/pack.py `mc_order` gives:
  // luma Q 4, chroma Q 2 or 4
  const int R = 1 << lr;
#define MC_RUN_L(CS)                                                        \
  mc_block_tile<8, 4, CS, 4>(ry, nullptr, pitch_y, pred_y + g * pbs_y,      \
                             nullptr, cnt_y + g * pbs_y, ps_y, taps_l, gx,  \
                             gy, py, px, x0, y0, R, bd, accumulate)
#define MC_RUN_C(CS, LQ)                                                    \
  mc_block_tile<4, 5, CS, 1 << (LQ)>(                                       \
      ru, rv, pitch_c, pred_u + g * pbs_c, pred_v + g * pbs_c,              \
      cnt_c + g * pbs_c, ps_c, taps_c, gx, gy, py, px, x0, y0, R, bd,       \
      accumulate)
#define MC_CASES(RUN, ...)       \
  switch (shape & 3) {           \
    case 0:                      \
      RUN(0 __VA_ARGS__);        \
      break;                     \
    case 1:                      \
      RUN(1 __VA_ARGS__);        \
      break;                     \
    case 2:                      \
      RUN(2 __VA_ARGS__);        \
      break;                     \
    default:                     \
      RUN(3 __VA_ARGS__);        \
  }
  switch (shape >> 11) {  // (plane << 2) | log2 Q
    case 2:
      MC_CASES(MC_RUN_L, )
      break;
    case 4 | 1:
      MC_CASES(MC_RUN_C, , 1)
      break;
    case 4 | 2:
      MC_CASES(MC_RUN_C, , 2)
      break;
    default:
      break;
  }
#undef MC_RUN_L
#undef MC_RUN_C
#undef MC_CASES
}

template <class Refs>
int launch(const void* rows, const void* order, const void* classes,
           int n_cls, int n_cta, const Refs& refs, int pitch_y, int pitch_c,
           void* pred_y, void* pred_u, void* pred_v, void* cnt_y,
           void* cnt_c, int ps_y, int ps_c, const void* taps_l,
           const void* taps_c, int bd, int add, long long pbs_y,
           long long pbs_c, void* stream) {
  if (n_cta > 0 && n_cls > 0) {
    mc_kernel<Refs><<<n_cta, MC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, (const int32_t*)order, (const int32_t*)classes,
        n_cls, refs, pitch_y, pitch_c, (int32_t*)pred_y, (int32_t*)pred_u,
        (int32_t*)pred_v, (int8_t*)cnt_y, (int8_t*)cnt_c, ps_y, ps_c,
        (const int32_t*)taps_l, (const int32_t*)taps_c, bd, add, pbs_y,
        pbs_c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: the whole MC table; order: device int32 [N, 2] (row, frame g);
// classes: this list's n_cls class rows (first CTA, first order entry,
// blocks, shape), n_cta CTAs (ops/pack.py `mc_order`); ref_y / ref_u /
// ref_v: host arrays of n_slots device plane pointers (ref_u, ref_v NULL
// for 4:0:0); pitches and plane strides in elements; add: 0 stores the
// list's predictions and counts (the first launch, on zero planes), 1
// adds them; pbs_y, pbs_c: the batch strides of the prediction (and
// count) planes, in elements (0 for one frame).
extern "C" int xevd_mc(const void* rows, const void* order,
                       const void* classes, int n_cls, int n_cta,
                       const void* const* ref_y, const void* const* ref_u,
                       const void* const* ref_v, int n_slots, int pitch_y,
                       int pitch_c, void* pred_y, void* pred_u, void* pred_v,
                       void* cnt_y, void* cnt_c, int ps_y, int ps_c,
                       const void* taps_l, const void* taps_c, int bd,
                       int add, long long pbs_y, long long pbs_c,
                       void* stream) {
  if (n_slots < 1 || n_slots > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  SlotTable refs = {};
  for (int s = 0; s < n_slots; ++s) {
    refs.y[s] = (const int16_t*)ref_y[s];
    if (ref_u) refs.u[s] = (const int16_t*)ref_u[s];
    if (ref_v) refs.v[s] = (const int16_t*)ref_v[s];
  }
  return launch(rows, order, classes, n_cls, n_cta, refs, pitch_y, pitch_c,
                pred_y, pred_u, pred_v, cnt_y, cnt_c, ps_y, ps_c, taps_l,
                taps_c, bd, add, pbs_y, pbs_c, stream);
}

// The GOP batch's list: references from the DPB ring ring_y / ring_u /
// ring_v (u, v NULL for 4:0:0) of D x Gd pictures a plane, sd / sg its
// strides over the ring entries and the GOPs (elements), t the step.
extern "C" int xevd_mc_ring(const void* rows, const void* order,
                            const void* classes, int n_cls, int n_cta,
                            const void* ring_y, const void* ring_u,
                            const void* ring_v, long long sd_y,
                            long long sg_y, long long sd_c, long long sg_c,
                            int D, int Gd, int t, int pitch_y, int pitch_c,
                            void* pred_y, void* pred_u, void* pred_v,
                            void* cnt_y, void* cnt_c, int ps_y, int ps_c,
                            const void* taps_l, const void* taps_c, int bd,
                            int add, long long pbs_y, long long pbs_c,
                            void* stream) {
  if (D < 1 || Gd < 1) return (int)cudaErrorInvalidValue;
  const Ring refs = {(const int16_t*)ring_y, (const int16_t*)ring_u,
                     (const int16_t*)ring_v, sd_y, sg_y, sd_c, sg_c, D, Gd,
                     t};
  return launch(rows, order, classes, n_cls, n_cta, refs, pitch_y, pitch_c,
                pred_y, pred_u, pred_v, cnt_y, cnt_c, ps_y, ps_c, taps_l,
                taps_c, bd, add, pbs_y, pbs_c, stream);
}
