// Pad-expand: the decoded picture's planes, edge-replicated by P samples on
// every side into the DPB picture planes, in one launch over Y, U and V.
//
// Replaces: xevd_tpu/ops/pipeline.py `_pad_out` (K14), jnp.pad(mode="edge")
// of y_area[:h, :w] by PAD_L and of u_area, v_area[:h/2, :w/2] by PAD_C.
// The wrapper is xevd_tpu_torch/ops/recon.py `pad_picture` (a picture, or
// the G pictures of a GOP batch step).
//
//   out[g][i][j] = src[g][clamp(i - P, 0, h - 1)][clamp(j - P, 0, w - 1)]
//
// Bound on the H100: memory.  Each source sample is read once and each
// output sample written once, with no arithmetic: a 1080p 4:2:0 picture
// reads 6.2 MB and writes 9.1 MB (4.6 us at 3.35 TB/s).
//
// Design: a thread writes 16 bytes (8 samples) of an output row, two such
// vectors a thread, both loaded before either is stored.  A CTA covers a
// contiguous range of one plane's (row, vector) index, so a warp's stores
// are 512 contiguous bytes of a row.  The grid's x axis runs over the CTAs
// of the planes one after the other (Y, then U, then V: one launch for the
// whole picture), its y axis over the frames of a GOP batch step.  Output
// row i reads source row clamp(i - P, 0, h - 1); where the vector lies in
// the row's interior its load is 16 bytes wide (the source rows are views
// at BORDER columns into bordered planes: the host checks pointer, pitch,
// batch stride and P for 16-byte alignment), the left and right bands
// broadcast the edge sample, and a vector across an edge gathers its
// samples one by one.  A plane whose source or output is not 16-byte
// aligned takes scalar loads or stores of the same vectors (its own path,
// not a fallback to the plain version), as does the last vector of a row
// whose output width is not a multiple of 8.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_THREADS 256
#define PAD_VPT 2                           // vectors a thread
#define PAD_VPC (PAD_THREADS * PAD_VPT)     // vectors a CTA
#define PAD_MAX_PLANES 3
#define PAD_DESC 9   // long longs a plane in the host's descriptor

namespace {

struct PadPlane {
  const int16_t* src;
  int16_t* dst;
  long long src_bs, dst_bs;   // batch strides (elements)
  int src_pitch, dst_pitch;   // row pitches (elements)
  int h, w, P;                // source crop, padding
  int Wo, nvec;               // output width, vectors an output row
  long long nv;               // vectors of one frame's output plane
  int vload, vstore;          // 16-byte loads / stores
  int cta0;                   // first CTA (blockIdx.x) of the plane
};

struct PadArgs {
  PadPlane p[PAD_MAX_PLANES];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint4 splat(int16_t s) {
  const uint32_t w = (uint32_t)(uint16_t)s * 0x10001u;
  return make_uint4(w, w, w, w);
}

__global__ void __launch_bounds__(PAD_THREADS)
pad_kernel(const PadArgs a, int np) {
  // the plane of this CTA, chosen field by field from the parameters (no
  // dynamic index into them, which would copy them to local memory)
  const int b = (int)blockIdx.x;
  const PadPlane q = (np > 2 && b >= a.p[2].cta0)   ? a.p[2]
                     : (np > 1 && b >= a.p[1].cta0) ? a.p[1]
                                                    : a.p[0];
  const int16_t* __restrict__ src = q.src + blockIdx.y * q.src_bs;
  int16_t* __restrict__ dst = q.dst + blockIdx.y * q.dst_bs;
  const long long base =
      (long long)(blockIdx.x - q.cta0) * PAD_VPC + threadIdx.x;
  uint4 val[PAD_VPT];
  int row[PAD_VPT], col[PAD_VPT];
#pragma unroll
  for (int t = 0; t < PAD_VPT; ++t) {
    const long long idx = base + t * PAD_THREADS;
    row[t] = -1;
    if (idx >= q.nv) continue;
    const int i = (int)(idx / q.nvec);
    const int j = (int)(idx - (long long)i * q.nvec) * 8;
    row[t] = i;
    col[t] = j;
    const int16_t* s = src + (long long)clampi(i - q.P, 0, q.h - 1) *
                                 q.src_pitch;
    const int c = j - q.P;      // source column of the vector's sample 0
    if (q.vload && c >= 0 && c + 8 <= q.w) {
      val[t] = __ldg((const uint4*)(s + c));
    } else if (c + 7 <= 0) {
      val[t] = splat(__ldg(s));                 // left band
    } else if (c >= q.w - 1) {
      val[t] = splat(__ldg(s + q.w - 1));       // right band
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lo = __ldg(s + clampi(c + 2 * e, 0, q.w - 1));
        const int hi = __ldg(s + clampi(c + 2 * e + 1, 0, q.w - 1));
        w[e] = (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
      }
      val[t] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int t = 0; t < PAD_VPT; ++t) {
    if (row[t] < 0) continue;
    int16_t* d = dst + (long long)row[t] * q.dst_pitch + col[t];
    if (q.vstore && col[t] + 8 <= q.Wo) {
      *(uint4*)d = val[t];
    } else {
      const uint32_t w[4] = {val[t].x, val[t].y, val[t].z, val[t].w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col[t] + e < q.Wo)
          d[e] = (int16_t)(e & 1 ? w[e >> 1] >> 16 : w[e >> 1] & 0xffff);
    }
  }
}

inline bool aligned16(const void* p, long long pitch, long long bs) {
  return ((uintptr_t)p & 15) == 0 && pitch % 8 == 0 && bs % 8 == 0;
}

}  // namespace

// desc: np planes of PAD_DESC long longs each: source pointer, output
// pointer, source row pitch, output row pitch, source batch stride, output
// batch stride (elements; 0 for one frame), h, w, P.  The output plane is
// (h + 2 P) x (w + 2 P).  G frames (grid y).  Returns cudaGetLastError().
extern "C" int xevd_pad_picture(const long long* desc, int np, int G,
                                void* stream) {
  if (np < 1 || np > PAD_MAX_PLANES || G < 1)
    return (int)cudaErrorInvalidValue;
  PadArgs a;
  long long ctas = 0;
  for (int k = 0; k < PAD_MAX_PLANES; ++k) {
    PadPlane& q = a.p[k];
    if (k >= np) {
      q = a.p[0];
      q.cta0 = INT_MAX;
      continue;
    }
    const long long* d = desc + PAD_DESC * k;
    q.src = (const int16_t*)(uintptr_t)d[0];
    q.dst = (int16_t*)(uintptr_t)d[1];
    q.src_pitch = (int)d[2];
    q.dst_pitch = (int)d[3];
    q.src_bs = d[4];
    q.dst_bs = d[5];
    q.h = (int)d[6];
    q.w = (int)d[7];
    q.P = (int)d[8];
    if (q.h < 1 || q.w < 1 || q.P < 0) return (int)cudaErrorInvalidValue;
    q.Wo = q.w + 2 * q.P;
    q.nvec = (q.Wo + 7) / 8;
    q.nv = (long long)(q.h + 2 * q.P) * q.nvec;
    q.vload = aligned16(q.src, q.src_pitch, q.src_bs) && q.P % 8 == 0;
    q.vstore = aligned16(q.dst, q.dst_pitch, q.dst_bs);
    q.cta0 = (int)ctas;
    ctas += (q.nv + PAD_VPC - 1) / PAD_VPC;
  }
  if (ctas > INT_MAX || G > 65535) return (int)cudaErrorInvalidValue;
  pad_kernel<<<dim3((unsigned)ctas, G), PAD_THREADS, 0,
               (cudaStream_t)stream>>>(a, np);
  return (int)cudaGetLastError();
}
