// The collapsed bit-flip recurrence of one row, in mean form (the body of the
// collapsed_row kernel and of the collapsed_scan kernel's row step) and in
// rss form (the collapsed_scan kernel's "fast" flavor, at the end).
//
// For each bit k in order, both states of z_k are scored by
// -D/2 log(1+q) - |x - mean|^2 / (2 sigma^2 (1+q)) with prior odds
// m_k / (N - m_k); only active columns with m_k > 0.5 may flip; then the
// carry (z, v = Mz, q = z'Mz, mean = zH) moves by column k of M and row k
// of H. A bit that may not flip and is 0 moves nothing and is skipped, as
// the plain version skips it.
#pragma once
#include "common.cuh"

// Called by every thread of a block of THREADS threads. M (K,K) and H
// (K,D) are row-major; x, u, mm, act are read only. mean (D) is updated
// in place, thread t owning the entries d = t (mod THREADS) throughout,
// so it needs no barrier of its own; v and z (K) are updated in place and
// shared by the block; q is the same in every thread on entry and on
// exit. Pointers may be to shared or global memory. On entry v, z and
// the caller's writes to mean must be visible (after a __syncthreads());
// on exit the moved v and z are visible to every thread. ``red`` holds
// 2 * THREADS / 32 floats of shared memory.
template <int THREADS>
__device__ void collapsed_row_recurrence(
    const float* __restrict__ M, const float* __restrict__ H,
    const float* __restrict__ x, float* __restrict__ mean, float* v,
    float* z, float& q, const float* __restrict__ u,
    const float* __restrict__ mm, const float* __restrict__ act, float N,
    float inv2s2, int K, int D, float* red) {
  constexpr int NW = THREADS / 32;
  const int tid = threadIdx.x;
  const float halfD = -0.5f * (float)D;
  for (int k = 0; k < K; ++k) {
    const float zk = z[k];
    const float mk = mm[k];
    const bool may = (act[k] > 0.f) && (mk > 0.5f);
    if (!may && zk == 0.f) continue;  // block-uniform: moves nothing
    const float vk = v[k];
    const float Mkk = M[(long)k * K + k];
    const float* Hk = H + (long)k * D;
    // state with bit k = 0, then with bit k = 1
    const float q0 = q - zk * (2.f * vk - Mkk);
    const float v0k = vk - zk * Mkk;
    const float q1 = q0 + 2.f * v0k + Mkk;
    float p0 = 0.f, p1 = 0.f;
    for (int d = tid; d < D; d += THREADS) {
      const float h = Hk[d];
      const float m0 = mean[d] - zk * h;
      const float m1 = m0 + h;
      const float r0 = x[d] - m0;
      const float r1 = x[d] - m1;
      p0 += r0 * r0;
      p1 += r1 * r1;
    }
    block_sum2<NW>(p0, p1, red);
    const float s0 = 1.f + q0;
    const float s1 = 1.f + q1;
    const float ll0 = halfD * logf(s0) - inv2s2 * p0 / s0;
    const float ll1 = halfD * logf(s1) - inv2s2 * p1 / s1;
    const float logodds =
        logf(fmaxf(mk, 1e-20f)) - logf(N - mk) + ll1 - ll0;
    const float znk = may ? (logodds > u[k] ? 1.f : 0.f) : zk;
    const bool pick1 = znk > 0.5f;
    for (int d = tid; d < D; d += THREADS) {
      const float m0 = mean[d] - zk * Hk[d];
      mean[d] = pick1 ? m0 + Hk[d] : m0;
    }
    // every thread has read v[k] and z[k] before the reduction's barrier,
    // so v and z may move now
    for (int i = tid; i < K; i += THREADS) {
      const float Mik = M[(long)i * K + k];
      const float v0 = v[i] - zk * Mik;
      v[i] = pick1 ? v0 + Mik : v0;
    }
    if (tid == 0) z[k] = znk;
    q = pick1 ? q1 : q0;
    __syncthreads();  // v, z moved; red free for the next step
  }
}

// The same recurrence in rss form (kernels/collapsed_row/fast.py): the
// likelihood reads the residual only through its norm, so the carry is
// (z, v = Mz, q = z'Mz, rss = |x - zH|^2, rH = H(x - zH)) and flipping bit
// k moves rss and rH by (+-2 rH_k + G_kk, -+G[k]) with G = HH' (symmetric,
// row k read as column k). O(K) work a bit and no reduction over D: warp
// 0 runs the whole pass, each lane holding v and rH at i = lane (mod 32)
// and every lane computing the bit's scalars from the same values; the
// other warps wait at the closing barrier. Only active columns are
// visited, in ascending order.
//
// Called by every thread of the block. M, G (K,K) row-major; u, mm, act
// read only; v, rH, z (K, shared memory) moved in place; q and rss are
// read from every thread on entry and are the moved values in every
// thread on exit, broadcast through bc (2 floats of shared memory). On
// entry v, rH, z must be visible (after a __syncthreads()); on exit the
// moved v, rH, z are visible to every thread.
__device__ void collapsed_row_recurrence_rss(
    const float* __restrict__ M, const float* __restrict__ G, float* v,
    float* rH, float* z, float& q, float& rss, const float* __restrict__ u,
    const float* __restrict__ mm, const float* __restrict__ act, float N,
    float inv2s2, int K, int D, float* bc) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float halfD = -0.5f * (float)D;
    for (int k = 0; k < K; ++k) {
      if (!(act[k] > 0.5f)) continue;
      const float zk = z[k];
      const float mk = mm[k];
      const bool may = mk > 0.5f;
      if (!may && zk == 0.f) continue;  // warp-uniform: moves nothing
      const float* Mk = M + (long)k * K;
      const float* Gk = G + (long)k * K;
      const float Mkk = Mk[k], Gkk = Gk[k];
      const float vk = v[k], rHk = rH[k];
      // state with bit k = 0, then with bit k = 1
      const float q0 = q - zk * (2.f * vk - Mkk);
      const float rss0 = rss + zk * (2.f * rHk + Gkk);
      const float v0k = vk - zk * Mkk;
      const float rH0k = rHk + zk * Gkk;
      const float q1 = q0 + 2.f * v0k + Mkk;
      const float rss1 = rss0 - 2.f * rH0k + Gkk;
      const float s0 = 1.f + q0;
      const float s1 = 1.f + q1;
      const float ll0 = halfD * logf(s0) - inv2s2 * rss0 / s0;
      const float ll1 = halfD * logf(s1) - inv2s2 * rss1 / s1;
      const float logodds =
          logf(fmaxf(mk, 1e-20f)) - logf(N - mk) + ll1 - ll0;
      const float znk = may ? (logodds > u[k] ? 1.f : 0.f) : zk;
      const bool pick1 = znk > 0.5f;
      __syncwarp();  // every lane has read v[k], rH[k] and z[k]
      for (int i = lane; i < K; i += 32) {
        const float v0 = v[i] - zk * Mk[i];
        v[i] = pick1 ? v0 + Mk[i] : v0;
        const float r0 = rH[i] + zk * Gk[i];
        rH[i] = pick1 ? r0 - Gk[i] : r0;
      }
      if (lane == 0) z[k] = znk;
      q = pick1 ? q1 : q0;
      rss = pick1 ? rss1 : rss0;
      __syncwarp();  // v, rH, z moved
    }
    if (lane == 0) {
      bc[0] = q;
      bc[1] = rss;
    }
  }
  __syncthreads();
  q = bc[0];
  rss = bc[1];
  __syncthreads();  // bc free again
}
