// The persistent dependency-driven scans (K5 csrc/intra.cu, K6/K7
// csrc/intra_main.cu): tickets, and flags published and awaited across the
// CTAs of one launch.
//
// A CTA takes its next ticket with `take_ticket`, so tickets are handed
// out in order: a ticket is a table row, or with a ticket order (the GOP
// batch's K5 scan, csrc/intra.cu) the row the order maps it to, an order
// in which every row comes after the rows it waits for.  A row waits only
// on rows with lower tickets, which CTAs already running hold, so a scan
// cannot deadlock, whatever its table holds (a malformed table can only
// read early).
//
// Ordering (the pattern of CUTLASS's cutlass/barrier.h): the CTA's threads
// write their samples, __syncthreads(), then one thread publishes with a
// fence.acq_rel.gpu before a relaxed store or add at device scope; the
// fence also releases what the other threads of the CTA wrote before the
// barrier.  A waiting thread spins with relaxed loads at device scope and
// then acquires with one fence.acq_rel.gpu (an acquire load in the loop
// would also invalidate the SM's L1 at every poll, under the CTAs of the
// same SM that are working), then __syncthreads() before any thread of
// its CTA reads.  Samples that other CTAs wrote are loaded with __ldcg
// (L2), never from the SM's L1, which is not coherent across SMs.
#pragma once
#include <stdint.h>

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Spins until *p >= v, then acquires what the writers of *p released.
__device__ __forceinline__ void wait_at_least(const int* p, int v) {
#pragma unroll 1
  while (ld_relaxed(p) < v) __nanosleep(32);
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// After __syncthreads(): publishes the CTA's writes, then *p = v.
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "st.relaxed.gpu.global.b32 [%0], %1;\n"
      :
      : "l"(p), "r"(v)
      : "memory");
}

// After __syncthreads(): publishes the CTA's writes, then *p += v.
__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "red.relaxed.gpu.global.add.s32 [%0], %1;\n"
      :
      : "l"(p), "r"(v)
      : "memory");
}

// The CTA's next row: thread 0 takes a ticket, every thread returns it.
// `slot` is a __shared__ int[2] and `it` the loop count: the two slots
// alternate, so thread 0 never overwrites a ticket that a slower thread of
// the CTA has still to read.
__device__ __forceinline__ int take_ticket(int* counter, int* slot, int it) {
  if (threadIdx.x == 0) slot[it & 1] = atomicAdd(counter, 1);
  __syncthreads();
  return slot[it & 1];
}
