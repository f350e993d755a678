// Two other designs of the fused Baseline luma deblock (K8), kept to be
// timed beside the port's `luma_kernel` (xevd_tpu_torch/csrc/deblock.cu)
// by tests/torch_luma_variants.py; not part of the port.
//   pairs: a lane owns the 8-byte word of columns 4g .. 4g + 3; a warp
//     filters the 31 shifted blocks e0 .. e0 + 30 (groups e0 - 1 .. e0 +
//     30), each block's vertical edge pairing a lane's upper word with the
//     next lane's lower word by shuffles.  Needs an 8-byte aligned area
//     and a pitch that is a multiple of 4.
//   tile: a CTA stages a tile of 8 block rows by 64 blocks in shared
//     memory with 16-byte loads (after the tile's strengths show an edge),
//     a thread filters 2 blocks there, and the tile's own columns are
//     stored back.  Needs a 16-byte aligned area and a pitch that is a
//     multiple of 8.
// Same arithmetic as `luma_kernel`; the script holds both to
// ops/deblock.py `luma_blocks_ref`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
#define FULL 0xffffffffu
__device__ __forceinline__ int div_trunc(int a, int k) {
  const int q = (a < 0 ? -a : a) >> k;
  return a < 0 ? -q : q;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ void luma_step(int& A, int& B, int& C, int& D,
                                          int st, int maxv) {
  const int d = div_trunc(A - B * 4 + C * 4 - D, 3);
  const int abs_d = d < 0 ? -d : d;
  const int t16 = max(0, (abs_d - st) * 2);
  const int clip = max(0, abs_d - t16);
  const int d1 = d < 0 ? -clip : clip;
  const int clip2 = clip >> 1;
  const int d2 = clampi(div_trunc(A - D, 2), -clip2, clip2);
  const int a = clampi(A - d2, 0, maxv), b = clampi(B + d1, 0, maxv);
  C = clampi(C - d1, 0, maxv);
  D = clampi(D + d2, 0, maxv);
  A = a;
  B = b;
}
__device__ __forceinline__ int lo16(uint32_t w) {
  return (int16_t)(w & 0xffff);
}
__device__ __forceinline__ int hi16(uint32_t w) { return (int16_t)(w >> 16); }
__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

// pairs (see above)
template <int R>
__global__ void __launch_bounds__(32 * R)
luma_pairs(int16_t* area, int stride, int H, int W,
           const int32_t* __restrict__ stv, const int32_t* __restrict__ sth,
           int maxv, long long area_bs, long long stv_bs, long long sth_bs) {
  const int hs = H >> 2, ws = W >> 2;
  const int lane = threadIdx.x;
  const int g = blockIdx.x * 31 + lane - 1;
  const int f = blockIdx.y * R + threadIdx.y;
  if (f > hs) return;                                  // warp-uniform
  const bool in = g >= 0 && g < ws;
  int sva = 0, svb = 0, sh = 0;
  if (in) {
    if (stv != nullptr && g >= 1) {
      const int32_t* s = stv + blockIdx.z * stv_bs + g;
      if (f >= 1) sva = s[(long)(f - 1) * ws];
      if (f < hs) svb = s[(long)f * ws];
    }
    if (sth != nullptr && f >= 1 && f < hs)
      sh = sth[blockIdx.z * sth_bs + (long)f * ws + g];
  }
  // the next lane's vertical edge (it filters this lane's upper word)
  int rva = __shfl_down_sync(FULL, sva, 1);
  int rvb = __shfl_down_sync(FULL, svb, 1);
  if (lane == 31) rva = rvb = 0;     // owns no upper word
  if (lane == 0) sva = svb = 0;      // owns no lower word, no left edge
  const bool own_lo = in && lane >= 1, own_hi = in && lane <= 30;
  const int sh_lo = own_lo ? sh : 0, sh_hi = own_hi ? sh : 0;
  const bool any = sva > 0 || svb > 0 || rva > 0 || rvb > 0 || sh_lo > 0 ||
                   sh_hi > 0;
  if (!__any_sync(FULL, any)) return;
  int16_t* base =
      area + blockIdx.z * area_bs + (long)(4 * f - 2) * stride + 4 * g;
  uint32_t lo[4], hi[4];
  bool nlo[4], nhi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    nlo[i] = (i < 2 ? sva : svb) > 0 || sh_lo > 0;
    nhi[i] = (i < 2 ? rva : rvb) > 0 || sh_hi > 0;
    lo[i] = hi[i] = 0;
    int16_t* q = base + (long)i * stride;
    if (nlo[i] && nhi[i]) {
      const uint2 w = *(const uint2*)q;
      lo[i] = w.x;
      hi[i] = w.y;
    } else if (nlo[i]) {
      lo[i] = *(const uint32_t*)q;
    } else if (nhi[i]) {
      hi[i] = *(const uint32_t*)(q + 2);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t L = __shfl_up_sync(FULL, hi[i], 1);
    const int s = i < 2 ? sva : svb;
    uint32_t nl = L;
    if (s > 0) {
      int A = lo16(L), B = hi16(L), C = lo16(lo[i]), D = hi16(lo[i]);
      luma_step(A, B, C, D, s, maxv);
      nl = pack16(A, B);
      lo[i] = pack16(C, D);
    }
    const uint32_t r = __shfl_down_sync(FULL, nl, 1);
    if ((i < 2 ? rva : rvb) > 0) hi[i] = r;
  }
  if (sh > 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t w = j ? hi[i] : lo[i];
          v[i] = h ? hi16(w) : lo16(w);
        }
        luma_step(v[0], v[1], v[2], v[3], sh, maxv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t& w = j ? hi[i] : lo[i];
          w = h ? pack16(lo16(w), v[i]) : pack16(v[i], hi16(w));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int16_t* q = base + (long)i * stride;
    const bool slo = nlo[i] && own_lo, shi = nhi[i] && own_hi;
    if (slo && shi) {
      *(uint2*)q = make_uint2(lo[i], hi[i]);
    } else if (slo) {
      *(uint32_t*)q = lo[i];
    } else if (shi) {
      *(uint32_t*)(q + 2) = hi[i];
    }
  }
}

// tile (see above)
#define TX 64
#define TY 8
#define SROW (4 * TX + 8)          // staged columns: 4 e0 - 8 .. 4 e0 + 4 TX
__global__ void __launch_bounds__(256)
luma_tile(int16_t* area, int stride, int H, int W,
          const int32_t* __restrict__ stv, const int32_t* __restrict__ sth,
          int maxv, long long area_bs, long long stv_bs, long long sth_bs) {
  __shared__ __align__(16) int16_t t[4 * TY][SROW];
  const int hs = H >> 2, ws = W >> 2;
  const int e0 = blockIdx.x * TX, f0 = blockIdx.y * TY;
  area += blockIdx.z * area_bs;
  int sv0[2], sv1[2], sh0[2], sh1[2];
  bool any = false;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int fl = (threadIdx.x >> 6) + 4 * k, el = threadIdx.x & 63;
    const int f = f0 + fl, e = e0 + el;
    sv0[k] = sv1[k] = sh0[k] = sh1[k] = 0;
    if (f <= hs && e <= ws) {
      if (stv != nullptr && e >= 1 && e < ws) {
        const int32_t* s = stv + blockIdx.z * stv_bs + e;
        if (f >= 1) sv0[k] = s[(long)(f - 1) * ws];
        if (f < hs) sv1[k] = s[(long)f * ws];
      }
      if (sth != nullptr && f >= 1 && f < hs) {
        const int32_t* s = sth + blockIdx.z * sth_bs + (long)f * ws + e;
        if (e >= 1) sh0[k] = s[-1];
        if (e < ws) sh1[k] = s[0];
      }
    }
    any |= sv0[k] > 0 || sv1[k] > 0 || sh0[k] > 0 || sh1[k] > 0;
  }
  if (!__syncthreads_or(any)) return;
  const int x0 = 4 * e0 - 8, y0 = 4 * f0 - 2;
  constexpr int NV = SROW / 8;
  for (int k = threadIdx.x; k < 4 * TY * NV; k += 256) {
    const int r = k / NV, v = k - r * NV;
    const int y = y0 + r, x = x0 + 8 * v;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (y >= 0 && y < H) {
      const int16_t* q = area + (long)y * stride + x;
      if (x >= 0 && x + 8 <= W) {
        w = *(const uint4*)q;
      } else if (x + 8 > 0 && x < W) {
        union { uint4 v; int16_t e[8]; } u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          u.e[j] = (x + j >= 0 && x + j < W) ? q[j] : 0;
        w = u.v;
      }
    }
    *(uint4*)&t[r][8 * v] = w;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (sv0[k] <= 0 && sv1[k] <= 0 && sh0[k] <= 0 && sh1[k] <= 0) continue;
    const int fl = (threadIdx.x >> 6) + 4 * k, el = threadIdx.x & 63;
    int x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t* q = (const uint32_t*)&t[4 * fl + i][4 * el + 6];
      const uint32_t a = q[0], b = q[1];
      x[i][0] = lo16(a);
      x[i][1] = hi16(a);
      x[i][2] = lo16(b);
      x[i][3] = hi16(b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = i < 2 ? sv0[k] : sv1[k];
      if (s > 0) luma_step(x[i][0], x[i][1], x[i][2], x[i][3], s, maxv);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = c < 2 ? sh0[k] : sh1[k];
      if (s > 0) luma_step(x[0][c], x[1][c], x[2][c], x[3][c], s, maxv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t* q = (uint32_t*)&t[4 * fl + i][4 * el + 6];
      q[0] = pack16(x[i][0], x[i][1]);
      q[1] = pack16(x[i][2], x[i][3]);
    }
  }
  __syncthreads();
  // store the tile's own columns 4 e0 - 2 .. 4 e0 + 4 TX - 3 (staged 6 ..
  // 4 TX + 5) of the rows inside the area
  for (int k = threadIdx.x; k < 4 * TY * NV; k += 256) {
    const int r = k / NV, v = k - r * NV;
    const int y = y0 + r, x = x0 + 8 * v;
    if (y < 0 || y >= H) continue;
    int16_t* q = area + (long)y * stride + x;
    const int lo = max(max(6 - 8 * v, 0), -x);
    const int hi = min(min(4 * TX + 6 - 8 * v, 8), W - x);
    if (lo == 0 && hi == 8) {
      *(uint4*)q = *(const uint4*)&t[r][8 * v];
    } else {
      for (int j = lo; j < hi; ++j) q[j] = t[r][8 * v + j];
    }
  }
}
}  // namespace

// design 0: pairs, 1: tile; returns cudaGetLastError()
extern "C" int luma_variant(int design, void* area, int stride, int H, int W,
                            const void* stv, const void* sth, int bd, int G,
                            long long area_bs, long long stv_bs,
                            long long sth_bs, void* stream) {
  const int hs = H >> 2, ws = W >> 2, maxv = (1 << bd) - 1;
  cudaStream_t s = (cudaStream_t)stream;
  int16_t* a = (int16_t*)area;
  const int32_t *v = (const int32_t*)stv, *h = (const int32_t*)sth;
  if (design == 0)
    luma_pairs<4><<<dim3((ws + 1 + 30) / 31, (hs + 4) / 4, G), dim3(32, 4),
                    0, s>>>(a, stride, H, W, v, h, maxv, area_bs, stv_bs,
                            sth_bs);
  else
    luma_tile<<<dim3((ws + TX) / TX, (hs + TY) / TY, G), 256, 0, s>>>(
        a, stride, H, W, v, h, maxv, area_bs, stv_bs, sth_bs);
  return (int)cudaGetLastError();
}
