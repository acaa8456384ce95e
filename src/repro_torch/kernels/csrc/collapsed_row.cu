// collapsed_row: one row's K-sequential collapsed bit-flip, mean form.
//
// Replaces collapsed_row_flip_pallas (src/repro/kernels/collapsed_row/
// kernel.py:97, body _kernel :33). The recurrence itself is
// collapsed_row_recurrence (collapsed_row.cuh), shared with the
// collapsed_scan kernel, which runs it for every row of the hybrid tail
// inside one launch; this kernel runs it once, for one row, and is the
// recurrence's check against its plain version.
//
// What bounds it on the H100: neither bytes nor operations. One row is
// K*D*4 bytes of H plus K*K*4 of M (45 KB at K=8, D=1024), a few
// nanoseconds of device memory time, while the K steps are sequential and
// each needs a reduction over D: the K dependent block reductions, and
// for a call from the host the launch itself, dominate. The kernel keeps
// x and the running mean in shared memory (each thread owns the same
// D/256 entries throughout, so they need no barrier), v and z in shared
// memory, and scores both states of a bit with one two-value block
// reduction (warp shuffles, one cross-warp stage); every thread then
// takes the same decision from the same sums.
#include <cuda_runtime.h>

#include "collapsed_row.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
collapsed_row_kernel(const float* __restrict__ M,
                     const float* __restrict__ H,
                     const float* __restrict__ x,
                     const float* __restrict__ z,
                     const float* __restrict__ v,
                     const float* __restrict__ q,
                     const float* __restrict__ mean,
                     const float* __restrict__ u,
                     const float* __restrict__ mm,
                     const float* __restrict__ act,
                     const float* __restrict__ Np,
                     const float* __restrict__ inv2s2_p,
                     float* __restrict__ zo, float* __restrict__ vo,
                     float* __restrict__ qo, float* __restrict__ meano,
                     int K, int D) {
  extern __shared__ float sh[];
  float* x_s = sh;             // D
  float* mean_s = x_s + D;     // D
  float* v_s = mean_s + D;     // K
  float* z_s = v_s + K;        // K
  float* red = z_s + K;        // 2 NW
  const int tid = threadIdx.x;

  for (int d = tid; d < D; d += THREADS) {
    x_s[d] = x[d];
    mean_s[d] = mean[d];
  }
  for (int i = tid; i < K; i += THREADS) {
    v_s[i] = v[i];
    z_s[i] = z[i];
  }
  float qv = *q;
  __syncthreads();
  collapsed_row_recurrence<THREADS>(M, H, x_s, mean_s, v_s, z_s, qv, u, mm,
                                    act, *Np, *inv2s2_p, K, D, red);
  for (int d = tid; d < D; d += THREADS) meano[d] = mean_s[d];
  for (int i = tid; i < K; i += THREADS) {
    vo[i] = v_s[i];
    zo[i] = z_s[i];
  }
  if (tid == 0) *qo = qv;
}

}  // namespace

// M (K,K), H (K,D), x (D), z, v, u, mm, act (K) float32 on CUDA device
// `device`; q, N, inv2s2 device scalars; outputs zo, vo (K), qo (scalar),
// meano (D). Returns the CUDA error of the launch (0 on success).
extern "C" int collapsed_row_launch(int device, const float* M,
                                    const float* H, const float* x,
                                    const float* z,
                                    const float* v, const float* q,
                                    const float* mean, const float* u,
                                    const float* mm, const float* act,
                                    const float* N, const float* inv2s2,
                                    float* zo, float* vo, float* qo,
                                    float* meano, int K, int D,
                                    void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (2ull * D + 2ull * K + 2ull * NW) * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        collapsed_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  collapsed_row_kernel<<<1, THREADS, smem, stream>>>(
      M, H, x, z, v, q, mean, u, mm, act, N, inv2s2, zo, vo, qo, meano, K,
      D);
  return (int)cudaGetLastError();
}
