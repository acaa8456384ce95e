// gaussian_sse: the masked residual sum of squares |X - (Z*active) A|^2.
//
// Replaces gaussian_sse_pallas (src/repro/kernels/gaussian_sse/kernel.py:28,
// body :17), which fuses mask -> product -> subtract -> square -> reduce
// per row block and accumulates one float32 scalar across its grid.
//
// What bounds it on the H100: at N=32768, K=64, D=1024 the product is
// 2*N*K*D = 4.3 GFLOP of float32 (about 64 us at 67 TFLOP/s) against
// 128 MiB of X (about 40 us at 3.35 TB/s), so float32 operations bound
// it. The design: a block owns ROWS rows; their masked z rows sit in
// shared memory (every thread reads the same entry: a broadcast), each
// thread walks its columns d, reads each A[k, d] once for all ROWS rows
// and keeps the ROWS predictions in registers, so A is read from L2 once
// per ROWS rows and the residual never reaches device memory. Squares
// are summed in float64 per thread and per block. The blocks' partial
// sums go to a buffer and a second one-block pass adds them in a fixed
// order: no float atomics, so repeated runs are bitwise equal. Inputs are
// float32 or bfloat16 (converted to float32 on load); the result is
// float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sse_partial_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                   const T* __restrict__ A, const T* __restrict__ act,
                   double* __restrict__ partial, int N, int D, int K) {
  extern __shared__ float zs[];  // ROWS x K masked z
  __shared__ double red[NW];
  const long row0 = (long)blockIdx.x * ROWS;
  const int nrows = (int)min((long)ROWS, (long)N - row0);
  for (int i = threadIdx.x; i < ROWS * K; i += THREADS) {
    const int r = i / K, k = i % K;
    zs[i] = r < nrows ? to_f(Z[(row0 + r) * K + k]) * to_f(act[k]) : 0.f;
  }
  __syncthreads();
  double acc = 0.0;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float pred[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) pred[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = to_f(A[(long)k * D + d]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pred[r] += zs[r * K + k] * a;
    }
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        const float res = to_f(X[(row0 + r) * D + d]) - pred[r];
        part += res * res;
      }
    }
    acc += (double)part;
  }
  const double s = block_sum<double, NW>(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS)
sse_final_kernel(const double* __restrict__ partial, int n,
                 float* __restrict__ out) {
  __shared__ double red[NW];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += THREADS) acc += partial[i];
  const double s = block_sum<double, NW>(acc, red);
  if (threadIdx.x == 0) *out = (float)s;
}

template <typename T>
cudaError_t launch(const void* X, const void* Z, const void* A,
                   const void* act, double* partial, float* out, int N,
                   int D, int K, cudaStream_t stream) {
  const int blocks = (N + ROWS - 1) / ROWS;
  const size_t smem = (size_t)ROWS * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sse_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (blocks > 0) {
    sse_partial_kernel<T><<<blocks, THREADS, smem, stream>>>(
        (const T*)X, (const T*)Z, (const T*)A, (const T*)act, partial, N, D,
        K);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  sse_final_kernel<<<1, THREADS, 0, stream>>>(partial, blocks, out);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the first pass = floats64 of partial-sum scratch needed.
extern "C" int gaussian_sse_blocks(int N) { return (N + ROWS - 1) / ROWS; }

// X (N,D), Z (N,K), A (K,D), act (K), all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1) on CUDA device `device`; partial:
// gaussian_sse_blocks(N) float64 scratch; out: float32 device scalar.
// Returns the CUDA error of the launches (0 on success).
extern "C" int gaussian_sse_launch(int device, const void* X,
                                   const void* Z, const void* A,
                                   const void* act,
                                   double* partial, float* out, int N, int D,
                                   int K, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = bf16 ? launch<__nv_bfloat16>(X, Z, A, act, partial, out, N, D, K,
                                   stream)
           : launch<float>(X, Z, A, act, partial, out, N, D, K, stream);
  return (int)e;
}
