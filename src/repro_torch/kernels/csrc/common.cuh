// Shared device helpers of the port's kernels.
#pragma once
#include <cuda_runtime.h>

// Butterfly warp sum: every lane ends with the same bits, because each
// stage adds the same two operands on both partner lanes (float addition
// is commutative), so a decision taken from the sum agrees across lanes.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Sum over a block of NW warps, returned to every thread in a fixed order
// (deterministic, no atomics). ``red`` holds NW slots of shared memory;
// the caller separates two uses of the same slots by a __syncthreads().
template <typename T, int NW>
__device__ __forceinline__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) s += red[w];
  return s;
}

// Two block sums for the price of one barrier: warp shuffles, then one
// cross-warp stage through 2*NW slots of ``red``. Same contract as
// block_sum.
template <int NW>
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[NW + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float sa = red[0], sb = red[NW];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    sa += red[w];
    sb += red[NW + w];
  }
  a = sa;
  b = sb;
}

// Asynchronous copies from global into shared memory (sm_80+): issue,
// close a group, wait until at most N groups are still in flight.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
