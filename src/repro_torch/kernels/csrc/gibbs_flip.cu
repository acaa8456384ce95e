// gibbs_flip: the blocked uncollapsed Gibbs sweep of Z | pi, A.
//
// Replaces gibbs_flip_pallas (src/repro/kernels/gibbs_flip/kernel.py:66,
// body _kernel :28). Per row n the residual R = x - zA is carried through
// K sequential steps: s = R.a_k + z_k |a_k|^2, logit = logit(pi_k) +
// (2s - |a_k|^2) / (2 sigma^2); on active k, z_k <- [logit > u_nk]; then
// R moves by (z_k - z_k') a_k.
//
// What bounds it on the H100: every step reads a_k (D floats) for every
// row. Whole A (K x D, 256 KiB at K=64, D=1024) does not fit a block's
// shared memory, and re-reading a_k per row from L2 would cost K*D*4
// bytes per row. The design: one warp per row, the row's residual in
// registers (D/32 floats per lane, up to D = 1024; past that the residual
// lives in a global scratch row), and a_k staged once per step in shared
// memory for all WARPS rows of the block (double-buffered, one barrier per
// step), so L2 traffic is K*D*4 bytes per WARPS rows. The dot product is a
// butterfly warp sum, so all lanes take the same decision. Device memory
// traffic is X, Z, u read once and Z written once. Rows past N are masked
// by bounds (they still join the barriers).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 16;  // rows per block
constexpr int THREADS = WARPS * 32;

__global__ void anorm_kernel(const float* __restrict__ A,
                             float* __restrict__ anorm, int K, int D) {
  const int k = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= K) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float a = A[(long)k * D + d];
    s += a * a;
  }
  s = warp_sum(s);
  if (lane == 0) anorm[k] = s;
}

__device__ __forceinline__ void stage_row(const float* __restrict__ src,
                                          float* dst, int D) {
  for (int d = threadIdx.x; d < D; d += THREADS) dst[d] = src[d];
}

// NPL > 0: the residual is NPL registers per lane (D <= 32 * NPL).
// NPL == 0: the residual is the row's slice of the global scratch Rg.
template <int NPL>
__global__ void __launch_bounds__(THREADS)
gibbs_flip_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                  const float* __restrict__ A,
                  const float* __restrict__ lpi,
                  const float* __restrict__ act,
                  const float* __restrict__ anorm,
                  const float* __restrict__ u,
                  const float* __restrict__ inv2s2_p,
                  float* __restrict__ Zout, float* __restrict__ Rg, int N,
                  int D, int K) {
  extern __shared__ float a_s[];  // 2 x D: a_k, double-buffered
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * WARPS + warp;
  const bool valid = row < N;
  const float inv2s2 = *inv2s2_p;
  const float* x = X + row * D;
  float* rg = Rg + (NPL == 0 && valid ? row * D : 0);

  constexpr int R = NPL > 0 ? NPL : 1;
  float r[R];
  if (valid) {
    if constexpr (NPL > 0) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        r[i] = d < D ? x[d] : 0.f;
      }
    } else {
      for (int d = lane; d < D; d += 32) rg[d] = x[d];
    }
  }

  // initial residual R = x - z A, streaming a_k through shared memory
  for (int k = 0; k < K; ++k) {
    float* buf = a_s + (k & 1) * D;
    stage_row(A + (long)k * D, buf, D);
    __syncthreads();
    if (valid) {
      const float zk = Z[row * K + k];
      if (zk != 0.f) {
        if constexpr (NPL > 0) {
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) r[i] -= zk * buf[d];
          }
        } else {
          for (int d = lane; d < D; d += 32) rg[d] -= zk * buf[d];
        }
      }
    }
  }

  // the K-sequential sweep (buffer parity continues from the loop above)
  for (int k = 0; k < K; ++k) {
    float* buf = a_s + ((K + k) & 1) * D;
    stage_row(A + (long)k * D, buf, D);
    __syncthreads();
    if (!valid) continue;
    float s = 0.f;
    if constexpr (NPL > 0) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) s += r[i] * buf[d];
      }
    } else {
      for (int d = lane; d < D; d += 32) s += rg[d] * buf[d];
    }
    s = warp_sum(s);
    const float zk = Z[row * K + k];
    const float ank = anorm[k];
    const float s0 = s + zk * ank;
    const float logit = lpi[k] + (2.f * s0 - ank) * inv2s2;
    const float znew =
        act[k] > 0.f ? (logit > u[row * K + k] ? 1.f : 0.f) : zk;
    const float delta = zk - znew;
    if (delta != 0.f) {
      if constexpr (NPL > 0) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) r[i] += delta * buf[d];
        }
      } else {
        for (int d = lane; d < D; d += 32) rg[d] += delta * buf[d];
      }
    }
    if (lane == 0) Zout[row * K + k] = znew;
  }
}

template <int NPL>
cudaError_t launch(const float* X, const float* Z, const float* A,
                   const float* lpi, const float* act, const float* anorm,
                   const float* u, const float* inv2s2, float* Zout,
                   float* Rg, int N, int D, int K, cudaStream_t stream) {
  const size_t smem = 2ull * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gibbs_flip_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (N + WARPS - 1) / WARPS;
  gibbs_flip_kernel<NPL><<<blocks, THREADS, smem, stream>>>(
      X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K);
  return cudaGetLastError();
}

}  // namespace

// Number of floats of global residual scratch the launch needs (0 when
// the residual fits in registers).
extern "C" long gibbs_flip_scratch_floats(int N, int D) {
  return D > 32 * 32 ? (long)N * D : 0;
}

// X (N,D), Z (N,K), A (K,D), lpi (K), act (K), u (N,K) float32 on CUDA
// device `device`; inv2s2 a device scalar; anorm (K) scratch; Zout (N,K)
// output; Rg scratch of gibbs_flip_scratch_floats(N, D) floats. Returns
// the CUDA error of the launches (0 on success).
extern "C" int gibbs_flip_launch(int device, const float* X, const float* Z,
                                 const float* A, const float* lpi,
                                 const float* act, const float* u,
                                 const float* inv2s2, float* anorm,
                                 float* Zout, float* Rg, int N, int D, int K,
                                 void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (N <= 0 || K <= 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  anorm_kernel<<<(K + 7) / 8, 256, 0, stream>>>(A, anorm, K, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int npl = (D + 31) / 32;
  if (npl <= 1)
    e = launch<1>(X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K,
                  stream);
  else if (npl <= 2)
    e = launch<2>(X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K,
                  stream);
  else if (npl <= 4)
    e = launch<4>(X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K,
                  stream);
  else if (npl <= 8)
    e = launch<8>(X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K,
                  stream);
  else if (npl <= 16)
    e = launch<16>(X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K,
                   stream);
  else if (npl <= 32)
    e = launch<32>(X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K,
                   stream);
  else
    e = launch<0>(X, Z, A, lpi, act, anorm, u, inv2s2, Zout, Rg, N, D, K,
                  stream);
  return (int)e;
}
