// The GOP batch of the batched kernels (K15, xevd_tpu/parallel/gop.py: the
// jax.vmap of the per-frame pipeline over a batch of GOPs).  The frames of
// one time step share one table: the rows of the batch's frame g are rows
// off[g] .. off[g + 1] - 1, and each of its planes lies at g times the
// plane's batch stride from the first.  A single frame is the batch of one
// (off NULL, g = 0).
#pragma once
#include <stdint.h>

// The frame g of table row `row`: the last g with off[g] <= row (frames
// without rows are skipped over).
__device__ __forceinline__ int batch_of(const int32_t* __restrict__ off,
                                        int G, int row) {
  if (off == nullptr) return 0;
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= row)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}
