// feature_stats: the master sync's sufficient statistics in one pass,
// Z^T Z (K,K), Z^T X (K,D) and m = column sums of Z (K).
//
// Replaces feature_stats_pallas (src/repro/kernels/feature_stats/kernel.py:36,
// body :21), which walks row blocks in order and accumulates all three
// products into one resident output block.
//
// What bounds it on the H100: at N=32768, K=64, D=1024 Z^T X is
// 2*N*K*D = 4.3 GFLOP of float32 (about 64 us at 67 TFLOP/s) against
// 136 MiB of X and Z (about 43 us at 3.35 TB/s), so float32 operations
// bound it. Hopper blocks run in parallel and in no order, so nothing can
// carry a sum from one block to the next: here each block owns one output
// tile (a KT-wide k range times a DT-wide column range of Z^T X, of
// Z^T Z, or of m) and loops over all N rows itself, so no atomics are
// needed and every run is bitwise equal. Rows arrive in chunks of RCH
// through shared memory; the next chunk's loads are issued into registers
// before the current chunk is used, to hide their latency. Each chunk's
// sum is float32 and the running total float64, so Z^T Z and m stay
// exact and Z^T X is accurate to about one float32 rounding.
#include <cuda_runtime.h>

namespace {

constexpr int KT = 16;    // k rows of an output tile
constexpr int DT = 32;    // columns of an output tile
constexpr int RCH = 64;   // rows per shared-memory chunk
constexpr int THREADS = 256;
constexpr int ZPER = RCH * KT / THREADS;  // 4 z values per thread
constexpr int YPER = RCH * DT / THREADS;  // 8 y values per thread

// Y = X (ld D), Z (ld K) or a column of ones (m = Z^T 1).
enum Mode { kX = 0, kZ = 1, kOnes = 2 };

__global__ void __launch_bounds__(THREADS)
feature_stats_kernel(const float* __restrict__ X,
                     const float* __restrict__ Z, float* __restrict__ ztz,
                     float* __restrict__ ztx, float* __restrict__ m, int N,
                     int D, int K) {
  __shared__ float zs[RCH][KT];
  __shared__ float ys[RCH][DT];
  const int nkt = (K + KT - 1) / KT;
  const int ndx = (D + DT - 1) / DT;
  const int ndz = (K + DT - 1) / DT;
  int b = blockIdx.x;
  Mode mode;
  int kt, dt;
  if (b < nkt * ndx) {
    mode = kX, kt = b / ndx, dt = b % ndx;
  } else if ((b -= nkt * ndx) < nkt * ndz) {
    mode = kZ, kt = b / ndz, dt = b % ndz;
  } else {
    mode = kOnes, kt = b - nkt * ndz, dt = 0;
  }
  const int k0 = kt * KT, c0 = dt * DT;
  const int ncols = mode == kX ? D : (mode == kZ ? K : 1);
  const float* Y = mode == kX ? X : Z;
  const int ldy = mode == kX ? D : K;
  const int tid = threadIdx.x;

  float zr[ZPER], yr[YPER];
  auto load = [&](long row0) {
#pragma unroll
    for (int j = 0; j < ZPER; ++j) {
      const int i = tid + THREADS * j;
      const long r = row0 + i / KT;
      const int c = k0 + i % KT;
      zr[j] = (r < N && c < K) ? Z[r * K + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < YPER; ++j) {
      const int i = tid + THREADS * j;
      const long r = row0 + i / DT;
      const int c = c0 + i % DT;
      float y = 0.f;
      if (r < N && c < ncols) y = mode == kOnes ? 1.f : Y[r * ldy + c];
      yr[j] = y;
    }
  };

  const int kk = tid / (DT / 2);  // 0..15
  const int dd = tid % (DT / 2);  // 0..15; this thread owns dd, dd + 16
  double acc0 = 0.0, acc1 = 0.0;
  load(0);
  for (long row0 = 0; row0 < N; row0 += RCH) {
#pragma unroll
    for (int j = 0; j < ZPER; ++j) {
      const int i = tid + THREADS * j;
      zs[i / KT][i % KT] = zr[j];
    }
#pragma unroll
    for (int j = 0; j < YPER; ++j) {
      const int i = tid + THREADS * j;
      ys[i / DT][i % DT] = yr[j];
    }
    __syncthreads();
    if (row0 + RCH < N) load(row0 + RCH);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int r = 0; r < RCH; ++r) {
      const float zv = zs[r][kk];
      s0 += zv * ys[r][dd];
      s1 += zv * ys[r][dd + DT / 2];
    }
    acc0 += (double)s0;
    acc1 += (double)s1;
    __syncthreads();
  }

  const int k = k0 + kk;
  if (k >= K) return;
  const int c = c0 + dd;
  if (mode == kOnes) {
    if (dd == 0) m[k] = (float)acc0;
    return;
  }
  float* out = mode == kX ? ztx : ztz;
  if (c < ncols) out[(long)k * ncols + c] = (float)acc0;
  if (c + DT / 2 < ncols) out[(long)k * ncols + c + DT / 2] = (float)acc1;
}

}  // namespace

// X (N,D), Z (N,K) float32 on CUDA device `device`; outputs ztz (K,K),
// ztx (K,D), m (K). Returns the CUDA error of the launch (0 on success).
extern "C" int feature_stats_launch(int device, const float* X,
                                    const float* Z, float* ztz, float* ztx,
                                    float* m, int N, int D, int K,
                                    void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (K <= 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nkt = (K + KT - 1) / KT;
  const int blocks = nkt * ((D + DT - 1) / DT) + nkt * ((K + DT - 1) / DT)
                     + nkt;
  feature_stats_kernel<<<blocks, THREADS, 0, stream>>>(X, Z, ztz, ztx, m, N,
                                                       D, K);
  return (int)cudaGetLastError();
}
