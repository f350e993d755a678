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
// Bound on the H100: memory traffic and launch width, not arithmetic.  A
// 64x64 luma NN block reads a 71x71 int16 window (10 KB) and does 8
// multiply-adds a sample a pass; the prediction and count planes are read
// and written once a list.
//
// Design: one launch per reference list over the frame's MC block table
// (ops/pack.py `pack_mc`), one CTA per block, blocks of every size and
// case in the same launch (no per-(size, case) buckets).  The CTA stages
// its window in shared memory, runs the horizontal pass into an int32
// shared buffer for NN, then the vertical or single pass, and adds its
// samples into the planes.  A chroma CTA does u then v with the same
// position and taps.  Within one list the blocks tile disjoint parts of
// the picture, and the two lists are two launches on one stream, so the
// read-modify-write of pred and cnt needs no atomics and is deterministic.
// A frame's reference planes come as a pointer table in the kernel's
// parameters (one pitch per plane group), so no plane is stacked or copied;
// a frame has at most MAX_SLOTS references (ops/pack.py refuses more).
//
// GOP batch (K15): the table of one list holds the blocks of the G frames
// of one time step, those of frame g at rows row_off[g] .. row_off[g + 1] -
// 1; a CTA adds into its frame's prediction and count planes (g times their
// batch stride).  Its references are the DPB ring of the batch, one tensor
// [D, G_dev, H, W] a plane (xevd_tpu_torch/parallel/gop.py): slot s =
// (d - 1) * G_dev + g is GOP g's picture d steps back from step t, ring
// entry ((t - d) mod D, g), which the CTA addresses by the ring's strides.
// So the batch takes any D x G_dev, as JAX's step does.  One launch a list
// and step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "batch.cuh"

#define MC_THREADS 256
#define MAX_SLOTS 32
#define MAX_WIN (64 + 7)

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
// ((t - d) mod D, g) with d = s / Gd + 1, g = s mod Gd.
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

// MC table row: plane, w, h, case, slot, gx, gy, py, px, list
template <int NTAP, int FBITS>
__device__ __forceinline__ void mc_plane(
    const int16_t* __restrict__ ref, int pitch, int32_t* __restrict__ pred,
    int8_t* __restrict__ cnt, int ps, const int32_t* __restrict__ taps,
    int w, int h, int cs, int gx, int gy, int py, int px, int bd,
    int16_t* s_win, int32_t* s_buf) {
  constexpr int HALF = NTAP / 2 - 1;
  const int fmask = (1 << FBITS) - 1;
  const bool hx = cs & 1, vy = cs & 2;
  const int ix = (gx >> FBITS) - (hx ? HALF : 0);
  const int iy = (gy >> FBITS) - (vy ? HALF : 0);
  const int ww = w + (hx ? NTAP - 1 : 0);
  const int wh = h + (vy ? NTAP - 1 : 0);
  int tx[NTAP], ty[NTAP];
#pragma unroll
  for (int k = 0; k < NTAP; ++k) {
    tx[k] = taps[(gx & fmask) * NTAP + k];
    ty[k] = taps[(gy & fmask) * NTAP + k];
  }
  const int maxv = (1 << bd) - 1;

  for (int i = threadIdx.x; i < wh * ww; i += blockDim.x) {
    const int r = i / ww, c = i - r * ww;
    s_win[i] = ref[(size_t)(iy + r) * pitch + ix + c];
  }
  __syncthreads();
  if (cs == 3) {
    const int shift1 = bd - 8 < 4 ? bd - 8 : 4;
    for (int i = threadIdx.x; i < wh * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < NTAP; ++k) acc += tx[k] * s_win[r * ww + c + k];
      s_buf[i] = (int16_t)(acc >> shift1);
    }
    __syncthreads();
  }
  const int shift2 = 20 - bd > 8 ? 20 - bd : 8;
  const int offset2 = 1 << (shift2 - 1);
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
    const int y = i / w, x = i - y * w;
    int v;
    if (cs == 0) {
      v = s_win[y * ww + x];
    } else {
      int acc = 0;
      if (cs == 1) {
#pragma unroll
        for (int k = 0; k < NTAP; ++k) acc += tx[k] * s_win[y * ww + x + k];
        acc >>= 6;
      } else if (cs == 2) {
#pragma unroll
        for (int k = 0; k < NTAP; ++k) acc += ty[k] * s_win[(y + k) * ww + x];
        acc >>= 6;
      } else {
#pragma unroll
        for (int k = 0; k < NTAP; ++k) acc += ty[k] * s_buf[(y + k) * w + x];
        acc = (acc + offset2) >> shift2;
      }
      v = acc < 0 ? 0 : (acc > maxv ? maxv : acc);
    }
    const size_t o = (size_t)(py + y) * ps + px + x;
    pred[o] += v;
    if (cnt) cnt[o] += 1;
  }
  __syncthreads();  // the window and buffer are reused by the next plane
}

template <class Refs>
__global__ void __launch_bounds__(MC_THREADS)
mc_kernel(const int32_t* __restrict__ rows, Refs refs, int pitch_y,
          int pitch_c,
          int32_t* pred_y, int32_t* pred_u, int32_t* pred_v, int8_t* cnt_y,
          int8_t* cnt_c, int ps_y, int ps_c,
          const int32_t* __restrict__ taps_l,
          const int32_t* __restrict__ taps_c, int bd,
          const int32_t* __restrict__ row_off, int G, long long pbs_y,
          long long pbs_c) {
  __shared__ int16_t s_win[MAX_WIN * MAX_WIN];
  __shared__ int32_t s_buf[MAX_WIN * 64];
  const int32_t* r = rows + (size_t)blockIdx.x * 10;
  const int plane = r[0], w = r[1], h = r[2], cs = r[3], slot = r[4];
  const int gx = r[5], gy = r[6], py = r[7], px = r[8];
  const long long g = batch_of(row_off, G, blockIdx.x);
  pred_y += g * pbs_y;
  cnt_y += g * pbs_y;
  if (plane) {
    pred_u += g * pbs_c;
    pred_v += g * pbs_c;
    cnt_c += g * pbs_c;
  }
  const int16_t *ry, *ru, *rv;
  refs.get(slot, ry, ru, rv);
  if (plane == 0) {
    mc_plane<8, 4>(ry, pitch_y, pred_y, cnt_y, ps_y, taps_l, w, h, cs, gx,
                   gy, py, px, bd, s_win, s_buf);
  } else {
    mc_plane<4, 5>(ru, pitch_c, pred_u, cnt_c, ps_c, taps_c, w, h, cs, gx,
                   gy, py, px, bd, s_win, s_buf);
    mc_plane<4, 5>(rv, pitch_c, pred_v, nullptr, ps_c, taps_c, w, h, cs, gx,
                   gy, py, px, bd, s_win, s_buf);
  }
}

template <class Refs>
int launch(const void* rows, int n_rows, const Refs& refs, int pitch_y,
           int pitch_c, void* pred_y, void* pred_u, void* pred_v,
           void* cnt_y, void* cnt_c, int ps_y, int ps_c, const void* taps_l,
           const void* taps_c, int bd, const void* row_off, int G,
           long long pbs_y, long long pbs_c, void* stream) {
  if (n_rows > 0) {
    mc_kernel<Refs><<<n_rows, MC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, refs, pitch_y, pitch_c, (int32_t*)pred_y,
        (int32_t*)pred_u, (int32_t*)pred_v, (int8_t*)cnt_y, (int8_t*)cnt_c,
        ps_y, ps_c, (const int32_t*)taps_l, (const int32_t*)taps_c, bd,
        (const int32_t*)row_off, G, pbs_y, pbs_c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ref_y / ref_u / ref_v: host arrays of n_slots device plane pointers
// (ref_u, ref_v NULL for 4:0:0); pitches and plane strides in elements.
// row_off: device int32 [G + 1] of the list's rows, or NULL for one frame
// (G 1); pbs_y, pbs_c: the batch strides of the prediction (and count)
// planes, in elements.
extern "C" int xevd_mc(const void* rows, int n_rows, const void* const* ref_y,
                       const void* const* ref_u, const void* const* ref_v,
                       int n_slots, int pitch_y, int pitch_c, void* pred_y,
                       void* pred_u, void* pred_v, void* cnt_y, void* cnt_c,
                       int ps_y, int ps_c, const void* taps_l,
                       const void* taps_c, int bd, const void* row_off, int G,
                       long long pbs_y, long long pbs_c, void* stream) {
  if (n_slots < 1 || n_slots > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  SlotTable refs = {};
  for (int s = 0; s < n_slots; ++s) {
    refs.y[s] = (const int16_t*)ref_y[s];
    if (ref_u) refs.u[s] = (const int16_t*)ref_u[s];
    if (ref_v) refs.v[s] = (const int16_t*)ref_v[s];
  }
  return launch(rows, n_rows, refs, pitch_y, pitch_c, pred_y, pred_u, pred_v,
                cnt_y, cnt_c, ps_y, ps_c, taps_l, taps_c, bd, row_off, G,
                pbs_y, pbs_c, stream);
}

// The GOP batch's list: references from the DPB ring ring_y / ring_u /
// ring_v (u, v NULL for 4:0:0) of D x Gd pictures a plane, sd / sg its
// strides over the ring entries and the GOPs (elements), t the step.
extern "C" int xevd_mc_ring(const void* rows, int n_rows, const void* ring_y,
                            const void* ring_u, const void* ring_v,
                            long long sd_y, long long sg_y, long long sd_c,
                            long long sg_c, int D, int Gd, int t,
                            int pitch_y, int pitch_c, void* pred_y,
                            void* pred_u, void* pred_v, void* cnt_y,
                            void* cnt_c, int ps_y, int ps_c,
                            const void* taps_l, const void* taps_c, int bd,
                            const void* row_off, int G, long long pbs_y,
                            long long pbs_c, void* stream) {
  if (D < 1 || Gd < 1) return (int)cudaErrorInvalidValue;
  const Ring refs = {(const int16_t*)ring_y, (const int16_t*)ring_u,
                     (const int16_t*)ring_v, sd_y, sg_y, sd_c, sg_c, D, Gd,
                     t};
  return launch(rows, n_rows, refs, pitch_y, pitch_c, pred_y, pred_u, pred_v,
                cnt_y, cnt_c, ps_y, ps_c, taps_l, taps_c, bd, row_off, G,
                pbs_y, pbs_c, stream);
}
