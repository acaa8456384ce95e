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
