// collapsed_row: one row's K-sequential collapsed bit-flip, mean form.
//
// Replaces collapsed_row_flip_pallas (src/repro/kernels/collapsed_row/
// kernel.py:97, body _kernel :33). For each bit k in order, both states
// of z_k are scored by -D/2 log(1+q) - |x - mean|^2 / (2 sigma^2 (1+q))
// with prior odds m_k / (N - m_k); only active columns with m_k > 0.5
// may flip; then the carry (z, v = Mz, q = z'Mz, mean = zH) moves by
// column k of M and row k of H.
//
// What bounds it on the H100: neither bytes nor operations. One row is
// K*D*4 bytes of H plus K*K*4 of M (45 KB at K=8, D=1024), a few
// nanoseconds of device memory time, while the K steps are sequential and
// each needs a reduction over D. The launch itself (a few microseconds)
// and the K dependent block reductions dominate. The design keeps x and
// the running mean in shared memory (each thread owns the same D/256
// entries throughout, so they need no barrier), v and z in shared memory,
// and scores both states of a bit with one fused two-value block
// reduction; every thread then takes the same decision from the same
// sums. The real fix, batching rows or fusing this recurrence with the
// row scan's carry moves, is later work.
#include <cuda_runtime.h>

#include "common.cuh"

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
  float* red0 = z_s + K;       // NW
  float* red1 = red0 + NW;     // NW
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
  const float N = *Np;
  const float inv2s2 = *inv2s2_p;
  const float halfD = -0.5f * (float)D;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float zk = z_s[k];
    const float vk = v_s[k];
    const float Mkk = M[(long)k * K + k];
    const float* Hk = H + (long)k * D;
    // state with bit k = 0, then with bit k = 1
    const float q0 = qv - zk * (2.f * vk - Mkk);
    const float v0k = vk - zk * Mkk;
    const float q1 = q0 + 2.f * v0k + Mkk;
    float p0 = 0.f, p1 = 0.f;
    for (int d = tid; d < D; d += THREADS) {
      const float h = Hk[d];
      const float m0 = mean_s[d] - zk * h;
      const float m1 = m0 + h;
      const float r0 = x_s[d] - m0;
      const float r1 = x_s[d] - m1;
      p0 += r0 * r0;
      p1 += r1 * r1;
    }
    const float ss0 = block_sum<float, NW>(p0, red0);
    const float ss1 = block_sum<float, NW>(p1, red1);
    const float s0 = 1.f + q0;
    const float s1 = 1.f + q1;
    const float ll0 = halfD * logf(s0) - inv2s2 * ss0 / s0;
    const float ll1 = halfD * logf(s1) - inv2s2 * ss1 / s1;
    const float mk = mm[k];
    const float logodds =
        logf(fmaxf(mk, 1e-20f)) - logf(N - mk) + ll1 - ll0;
    const bool may = (act[k] > 0.f) && (mk > 0.5f);
    const float znk = may ? (logodds > u[k] ? 1.f : 0.f) : zk;
    const bool pick1 = znk > 0.5f;
    for (int d = tid; d < D; d += THREADS) {
      const float m0 = mean_s[d] - zk * Hk[d];
      mean_s[d] = pick1 ? m0 + Hk[d] : m0;
    }
    // every thread has read v_s[k] and z_s[k] (before the reductions'
    // barrier), so v and z may move now
    for (int i = tid; i < K; i += THREADS) {
      const float Mik = M[(long)i * K + k];
      const float v0 = v_s[i] - zk * Mik;
      v_s[i] = pick1 ? v0 + Mik : v0;
    }
    if (tid == 0) z_s[k] = znk;
    qv = pick1 ? q1 : q0;
    __syncthreads();
  }

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
