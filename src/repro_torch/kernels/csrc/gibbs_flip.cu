// gibbs_flip: the blocked uncollapsed Gibbs sweep of Z | pi, A, in Gram
// form.
//
// Replaces gibbs_flip_pallas (src/repro/kernels/gibbs_flip/kernel.py:66,
// body _kernel :28). Per row n the reference carries the residual
// R = x - zA through K sequential steps: s0 = R.a_k + z_k |a_k|^2,
// logit = logit(pi_k) + (2 s0 - |a_k|^2) / (2 sigma^2); on active k,
// z_k <- [logit > u_nk]; then R moves by (z_k - z_k') a_k. Here the same
// sweep runs in Gram form. With P = X A^T and G = A A^T,
//
//   s0_k = P_nk - C_nk + z_k G_kk,   C_nk = sum_j z_j G_jk,
//
// and a flip of z_k by delta moves the carry C_n by delta G_k: K
// operations, not D. Only active columns are decided, so P, the columns
// of G and C are kept for the active columns alone (their indices in
// order, `idx`); every z, active or not, enters C as it enters the
// reference's residual.
//
// What bounds it on the H100: bytes. At N=32768, K=64, D=1024, X is
// 128 MiB (about 40 us at 3.35 TB/s). The product P is 2 N D n_act
// operations (2.7 GFLOP at 40 active columns), three times that as
// 3xTF32 on mma.sync; the recurrence is N n_act dependent steps of a few
// float64 operations.
//
// Design:
//   * gibbs_gram_kernel: G[j][b] = a_j . a_idx[b] in float64 (exact
//     float32 products, float64 sums) for every row j and active column
//     b, into a scratch of K x n_act doubles (pitch n_act), a warp per
//     entry. It stays in L2 for the sweep.
//   * gibbs_flip_kernel: a block of 8 warps owns BM = 64 rows.
//     Product phase: P_tile = X_tile A_act^T by mma.sync in 3xTF32 (x and
//     a split by truncation into hi + lo; xlo ahi + xhi alo + xhi ahi).
//     X's tile and A's active rows (gathered by idx) stream through a
//     two-stage cp.async ring, 64 columns of D a stage. Warp w computes
//     rows 16 (w % 4).. and n-tiles w / 4, w / 4 + 2, ...; n-tiles past
//     n_act are skipped. Each 64-wide chunk of D is summed in float32 by
//     the tensor cores and added to the float64 P tile in shared memory
//     in ascending order (the float64 parts are needed: on planted data
//     P, G and C in float32 lose about 2e-3 of a logit to cancellation).
//     X's tile is read once for every 64 active columns (once at the
//     main path's 40); neither P nor a residual reaches device memory.
//   * The carry of the input z, C = Z G, on the FP64 tensor cores
//     (mma.sync m8n8k4, z exact): the P tile becomes R = P - C.
//   * Recurrence phase, a lane per row (warps 0 and 1, no block
//     barriers, no shuffles): with R_b = P_b - C_b over the current z,
//     s0_b = R_b + z_b G_bb and the decision z_b <- [logit > u] is
//     R_b > (u - logit(pi)) sigma^2 - (z_b - 1/2) G_bb. The active
//     columns go RB = 8 at a time: their R, thresholds and z are loaded
//     first, then decided in order, each move delta applied to the
//     block's later R in registers (R_i -= delta G_ki, so a step's
//     dependent chain is a compare, a select and an fma). The block's
//     moves then reach the later columns' R in the tile as one rank-8
//     update on the FP64 tensor cores (the moves staged through shared
//     memory as the A operand).
//   * Column passes: the P tile holds at most `cb` active columns (all of
//     them while K <= 296 on an H100). Beyond that the active columns go
//     in passes of cb (a multiple of 64): each pass computes its columns
//     of P, subtracts the carry of the current z (the decisions of the
//     earlier passes included) and runs their recurrence.
//   * G, Z and u are staged in shared memory when there is one pass and
//     they fit beside the P tile (on an H100: G while K <= 114, Z and u
//     while K <= 216) and read from global memory (L2) through the same
//     pointers otherwise. Z and u rows and the P tile have odd pitches, so
//     a lane per row reading one column hits distinct banks. The limit on
//     K (gibbs_flip_max_k, 7808 on an H100) is the shared memory of the
//     per-column arrays (idx, G_kk, logit(pi): 16 bytes a column) beside a
//     64-column P tile and the ring.
//   * Z is written once, coalesced from the staged tile (or, unstaged, as
//     a copy of the rows and then the decisions). No atomics, a fixed
//     order everywhere: two calls with the same inputs give bitwise the
//     same Z.
//
// What holds it back (PERF.md, section 6): the product phase, about two
// thirds of a block's time, split between the mma.sync products and
// waits at the block barrier of each stage of the two-stage ring; then
// the recurrence, two warps of dependent float64 steps.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int BM = 64;    // rows of a block
constexpr int BK = 64;    // columns of D a stage (one float32 chunk)
constexpr int BC = 64;    // active columns of P a stage
constexpr int LD = BK + 4;  // padded pitch: conflict-free fragment loads
constexpr int NSTAGE = 2;
constexpr int NS = 4;   // n-tiles of a warp in a stage: w / 4 + 2 j
constexpr int RB = 8;  // columns of R a lane holds in registers (2 k4 steps)
constexpr int RING_BYTES = NSTAGE * (BC + BM) * LD * 4;
constexpr int MAX_DEVICES = 64;

// The active columns of act, in order, into idx (shared); returns their
// number. Run by one whole warp.
__device__ int active_index(const float* __restrict__ act, int K, int* idx) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    const bool on = k < K && act[k] > 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (on) idx[n + __popc(m & ((1u << lane) - 1u))] = k;
    n += __popc(m);
  }
  return n;
}

// G[j][b] = a_j . a_idx[b] for b < n_act, pitch n_act: warp w of block
// (j, y) takes b = 8 y + w. Four float64 sums per lane, float4 loads
// where rows are 16-byte aligned. Dynamic shared memory: idx, K ints.
__global__ void __launch_bounds__(THREADS)
gibbs_gram_kernel(const float* __restrict__ A, const float* __restrict__ act,
                  double* __restrict__ G, int K, int D, bool va) {
  extern __shared__ int idx[];
  __shared__ int n_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const int n = active_index(act, K, idx);
    if (lane == 0) n_s = n;
  }
  __syncthreads();
  const int n_act = n_s, j = blockIdx.x, b = blockIdx.y * NW + warp;
  if (b >= n_act) return;
  const float* aj = A + (long)j * D;
  const float* ab = A + (long)idx[b] * D;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  int d = lane;
  if (va) {
#pragma unroll 4
    for (int d4 = 4 * lane; d4 + 3 < D; d4 += 128) {
      const float4 x = *reinterpret_cast<const float4*>(aj + d4);
      const float4 y = *reinterpret_cast<const float4*>(ab + d4);
      s0 = fma((double)x.x, (double)y.x, s0);
      s1 = fma((double)x.y, (double)y.y, s1);
      s2 = fma((double)x.z, (double)y.z, s2);
      s3 = fma((double)x.w, (double)y.w, s3);
    }
    d = D / 4 * 4 + lane;
  }
  for (; d < D; d += 32) s0 = fma((double)aj[d], (double)ab[d], s0);
  const double s = warp_sum((s0 + s1) + (s2 + s3));
  if (lane == 0) G[(long)j * n_act + b] = s;
}

// The products of one stage for a warp's rows 16 mt.. and its first NL
// n-tiles nh + 2 j: x and a split into hi + lo, xhi ahi into ch and
// xlo ahi + xhi alo into cl. One unrolled body per count of live tiles,
// so the tiles' loads and products interleave (a branch per tile would
// serialise them).
template <int NL>
__device__ __forceinline__ void stage_products(float (&ch)[NS][4],
                                               float (&cl)[NS][4],
                                               const float* Xs,
                                               const float* As, int mt,
                                               int nh, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    const float* x = Xs + (mt * 16 + g) * LD + ks * 8 + t;
    uint32_t xh[4], xl[4];
    split(x[0], xh[0], xl[0]);
    split(x[8 * LD], xh[1], xl[1]);
    split(x[4], xh[2], xl[2]);
    split(x[8 * LD + 4], xh[3], xl[3]);
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const float* a = As + ((nh + 2 * j) * 8 + g) * LD + ks * 8 + t;
      uint32_t ah[2], al[2];
      split(a[0], ah[0], al[0]);
      split(a[4], ah[1], al[1]);
      mma_tf32(cl[j], xl, ah);
      mma_tf32(ch[j], xh, ah);
      mma_tf32(cl[j], xh, al);
    }
  }
}

// Dynamic shared memory: [region | P tile | moves | G_kk | logit(pi) |
// idx]. The region holds the ring in the product phase, then, with one
// pass, G (if staged) and the block's Z and u rows (if staged).
struct Plan {
  int cb;            // active columns of a pass (all K, or a multiple of BC)
  int ldp;           // pitch of the P tile, in doubles
  int region;        // bytes of the region
  int bytes;         // all of it
  bool g_smem, zu_smem;
};

// Odd pitches (in doubles for P, floats for Z and u): a lane per row
// reading one column hits 32 distinct banks.
inline int pitch_p(int cb) { return (cb + 7) / 8 * 8 + 1; }
__host__ __device__ inline int pitch_z(int K) { return K | 1; }
inline long fixed_bytes(int K, int cb) {
  return (long)BM * pitch_p(cb) * 8 + BM * (RB + 1) * 8 + (long)K * 16;
}

// One pass over all K columns if its P tile fits, with G, Z and u staged
// where they fit too; else passes of the most multiples of BC columns
// that fit, nothing staged. Needs K <= gibbs_flip_max_k.
Plan plan(int K, int limit) {
  Plan p{K, pitch_p(K), RING_BYTES, 0, false, false};
  if (fixed_bytes(K, K) + RING_BYTES > limit) {
    const long room = limit - RING_BYTES - fixed_bytes(K, 0) + BM * 8;
    p.cb = (int)(room / (BM * 8) - 1) / BC * BC;  // pitch_p(cb) = cb + 1
    if (p.cb < BC) p.cb = BC;
    p.ldp = pitch_p(p.cb);
  } else {
    const long fixed = fixed_bytes(K, K);
    const long zu = 2L * BM * pitch_z(K) * 4, g = (long)K * K * 8;
    auto fits = [&](long need) {
      return fixed + (need > RING_BYTES ? need : RING_BYTES) <= limit;
    };
    if (fits(g + zu)) {
      p.g_smem = p.zu_smem = true;
      p.region = (int)(g + zu > RING_BYTES ? g + zu : RING_BYTES);
    } else if (fits(zu)) {
      p.zu_smem = true;
      p.region = (int)(zu > RING_BYTES ? zu : RING_BYTES);
    }
  }
  p.region = (p.region + 15) / 16 * 16;
  p.bytes = (int)(p.region + fixed_bytes(K, p.cb));
  return p;
}

__global__ void __launch_bounds__(THREADS, 2)
gibbs_flip_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                  const float* __restrict__ A,
                  const float* __restrict__ lpi,
                  const float* __restrict__ act,
                  const float* __restrict__ u,
                  const float* __restrict__ inv2s2_p,
                  const double* __restrict__ Gg, float* __restrict__ Zout,
                  int N, int D, int K, Plan pl, bool vx, bool va) {
  extern __shared__ float4 sh4[];
  char* sh = reinterpret_cast<char*>(sh4);
  float* ring = reinterpret_cast<float*>(sh);
  double* Ps = reinterpret_cast<double*>(sh + pl.region);
  double* Ds = Ps + BM * pl.ldp;  // the moves of RB columns, a row a lane
  double* gd = Ds + BM * (RB + 1);
  float* lpa = reinterpret_cast<float*>(gd + K);
  int* idx = reinterpret_cast<int*>(lpa + K);
  __shared__ int n_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = (long)blockIdx.x * BM;
  const int rows = (int)min((long)BM, N - row0);

  if (warp == 0) {
    const int n = active_index(act, K, idx);
    if (lane == 0) n_s = n;
  }
  __syncthreads();
  const int n_act = n_s;
  for (int b = tid; b < n_act; b += THREADS) {
    gd[b] = Gg[(long)idx[b] * n_act + b];
    lpa[b] = lpi[idx[b]];
  }

  // Zw: the block's current z, where decisions go (its input rows at
  // first); Ur: their u; both with pitch zp. Unstaged, the output rows
  // start as a copy of the input.
  float* Zw = Zout + row0 * K;
  const float* Ur = u + row0 * K;
  int zp = K;
  if (!pl.zu_smem)
    for (int i = tid; i < rows * K; i += THREADS) Zw[i] = Z[row0 * K + i];
  const double* G = Gg;

  // warp w: rows 16 (w % 4).., n-tiles w / 4 + 2 j of a stage
  const int mt = warp & 3, nh = warp >> 2;
  const int nd = max(1, (D + BK - 1) / BK);
  int c0 = 0;
  do {  // a pass over active columns [c0, cend); at least one, for staging
    const int cend = min(c0 + pl.cb, n_act);

    // ---- product phase: Ps[r][b - c0] = x_r . a_idx[b] ----
    const int nsteps = ((cend - c0 + BC - 1) / BC) * nd;
    auto load = [&](int s) {
      float* st = ring + (s % NSTAGE) * (BC + BM) * LD;
      const int b0 = c0 + (s / nd) * BC, d0 = (s % nd) * BK;
      for (int i = tid; i < BC * (BK / 4); i += THREADS) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        float* dst = st + r * LD + c;
        const float* src =
            b0 + r < cend ? A + (long)idx[b0 + r] * D : nullptr;
        if (src && va && d0 + c + 3 < D) {
          cp_async16(dst, src + d0 + c);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (src && d0 + c + q < D)
              cp_async4(dst + q, src + d0 + c + q);
            else
              dst[q] = 0.f;
          }
        }
      }
      stage_tile<float, BM, BK, LD, THREADS>(st + BC * LD, X, row0, N, d0,
                                             D, vx);
    };

#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nsteps) load(s);
      cp_async_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
      if (s + NSTAGE - 1 < nsteps) load(s + NSTAGE - 1);
      cp_async_commit();
      cp_async_wait<NSTAGE - 1>();
      __syncthreads();
      const int b0 = (s / nd) * BC, dk = s % nd;  // b0 within the pass
      const int live = min(BC, cend - c0 - b0);  // active columns of the stage
      const float* As = ring + (s % NSTAGE) * (BC + BM) * LD;
      const float* Xs = As + BC * LD;
      float ch[NS][4], cl[NS][4];  // hi*hi, and the two cross products
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) ch[j][q] = cl[j][q] = 0.f;
      switch (min(NS, (((live + 7) / 8) - nh + 1) / 2)) {  // live n-tiles
        case 1: stage_products<1>(ch, cl, Xs, As, mt, nh, g, t); break;
        case 2: stage_products<2>(ch, cl, Xs, As, mt, nh, g, t); break;
        case 3: stage_products<3>(ch, cl, Xs, As, mt, nh, g, t); break;
        case 4: stage_products<4>(ch, cl, Xs, As, mt, nh, g, t); break;
        default: break;
      }
      // the chunk's float32 sums join the float64 ones of the P tile in
      // ascending order (each thread owns its fragment's entries)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int nt = nh + 2 * j;
        if (nt * 8 >= live) continue;
        double* d = Ps + (mt * 16 + g) * pl.ldp + b0 + nt * 8 + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          double* e = d + (q >> 1) * 8 * pl.ldp + (q & 1);
          *e = (dk == 0 ? 0.0 : *e) + ((double)ch[j][q] + (double)cl[j][q]);
        }
      }
      __syncthreads();  // the stage may be refilled
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- one pass: stage G, Z and u into the region (where they fit) ----
    if (pl.g_smem) {
      double* Gs = reinterpret_cast<double*>(sh);
      const float* src = reinterpret_cast<const float*>(Gg);
      float* dst = reinterpret_cast<float*>(Gs);
      for (int i = tid; i < 2 * K * n_act; i += THREADS)
        cp_async4(dst + i, src + i);
      G = Gs;
    }
    if (pl.zu_smem) {  // decided in place, copied out at the end
      zp = pitch_z(K);
      float* zs = reinterpret_cast<float*>(sh + (pl.g_smem ? K * K * 8 : 0));
      float* us = zs + BM * zp;
      for (int i = tid; i < rows * K; i += THREADS) {
        const int r = i / K, c = i - r * K;
        cp_async4(zs + r * zp + c, Z + row0 * K + i);
        cp_async4(us + r * zp + c, Ur + i);
      }
      Zw = zs;
      Ur = us;
    }
    if (pl.g_smem || pl.zu_smem) {
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }

    // ---- C = z G on the FP64 tensor cores: the P tile becomes R = P - C
    // (z as it stands: the earlier passes' decisions included) ----
    {
      const int r = warp * 8 + g;  // warp w: rows 8 w .. 8 w + 7
      for (int n0 = c0; n0 < cend; n0 += 32) {  // four n-tiles at a time
        double c[4][2] = {};
        for (int k0 = 0; k0 < K; k0 += 4) {
          const int k = k0 + t;
          const double a = k < K && r < rows ? (double)Zw[r * zp + k] : 0.0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + 8 * j + g;
            mma_f64(c[j], a, k < K && n < cend ? G[(long)k * n_act + n] : 0.0);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = n0 + 8 * j + 2 * t + q;
            if (col < cend) Ps[r * pl.ldp + col - c0] -= c[j][q];
          }
      }
    }
    __syncthreads();

    // ---- recurrence phase: a lane per row, warps 0 and 1 ----
    // R_b = P_b - C_b over the current z; s0 = R_b + z_b G_bb, and
    // logit > u is R_b > (u - logit(pi)) sigma^2 - (z_b - 1/2) G_bb
    // (inv2s2 > 0; at inv2s2 = 0 the infinite sigma^2 leaves the test
    // logit(pi) > u, as it should). A move delta of column k moves every
    // R_b by -delta G_kb. The columns go RB at a time: their R in
    // registers, decided in order with the moves applied as they come;
    // then the block's moves reach the pass's later columns' R in the
    // tile as one rank-RB update on the FP64 tensor cores (later passes
    // see them through their carry).
    if (warp < BM / 32) {
      const double s2 = 0.5 / (double)*inv2s2_p;  // sigma^2
      const int r = warp * 32 + lane;
      const bool valid = r < rows;
      const int rr = valid ? r : 0;  // reads of an idle lane stay in range
      double* Rw = Ps + warp * 32 * pl.ldp;  // the warp's 32 rows
      double* Rr = Rw + lane * pl.ldp;
      double* Dw = Ds + warp * 32 * (RB + 1);
      float* zw = Zw + rr * zp;
      const float* ur = Ur + rr * zp;
      for (int kb = c0; kb < cend; kb += RB) {
        const int nb = min(RB, cend - kb);
        int kk[RB];
        double R[RB], thr[RB], d[RB];
        float zs[RB];
#pragma unroll
        for (int s = 0; s < RB; ++s) {
          kk[s] = 0;
          R[s] = thr[s] = d[s] = 0.0;
          zs[s] = 0.f;
          if (s >= nb) continue;
          const int b = kb + s;
          kk[s] = idx[b];
          R[s] = Rr[b - c0];
          zs[s] = zw[kk[s]];
          thr[s] = ((double)ur[kk[s]] - (double)lpa[b]) * s2 -
                   ((double)zs[s] - 0.5) * gd[b];
        }
#pragma unroll
        for (int s = 0; s < RB; ++s) {
          if (s >= nb) continue;
          const bool on = R[s] > thr[s];
          d[s] = on ? 1.0 - (double)zs[s] : -(double)zs[s];
          const double* gr = G + (long)kk[s] * n_act + kb;
#pragma unroll
          for (int i = s + 1; i < RB; ++i)
            if (i < nb) R[i] = fma(-d[s], gr[i], R[i]);
        }
        if (valid) {
#pragma unroll
          for (int s = 0; s < RB; ++s)
            if (s < nb) zw[kk[s]] = (float)((double)zs[s] + d[s]);
        }
        if (kb + RB >= cend) break;
        // R[:, kb + RB:cend] += (-D) G[k_s, kb + RB:cend], m8n8k4
        // fragments: A from the moves (row g, step t), B from G (step t,
        // column g), C from the R tile (row g, columns 2t, 2t + 1)
#pragma unroll
        for (int s = 0; s < RB; ++s) Dw[lane * (RB + 1) + s] = -d[s];
        __syncwarp();
        for (int n0 = kb + RB; n0 < cend; n0 += 8) {
          double bg[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int s = 4 * q + t, n = n0 + g;
            bg[q] = s < nb && n < cend ? G[(long)idx[kb + s] * n_act + n] : 0.0;
          }
          const int col = n0 + 2 * t;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            double* cr = Rw + (mt * 8 + g) * pl.ldp + col - c0;
            double c[2] = {col < cend ? cr[0] : 0.0,
                           col + 1 < cend ? cr[1] : 0.0};
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_f64(c, Dw[(mt * 8 + g) * (RB + 1) + 4 * q + t], bg[q]);
            if (col < cend) cr[0] = c[0];
            if (col + 1 < cend) cr[1] = c[1];
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // z reach the next pass's carry; the P tile is reused
    c0 = cend;
  } while (c0 < n_act);

  if (pl.zu_smem)  // the decided tile, coalesced
    for (int i = tid; i < rows * K; i += THREADS) {
      const int r = i / K;
      Zout[row0 * K + i] = Zw[r * zp + i - r * K];
    }
}

int smem_limit(int device) {
  static int limits[MAX_DEVICES] = {};
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && limits[device] > 0) return limits[device];
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess || v <= 0)
    v = 232448;  // an H100's 227 KiB
  if (cached) limits[device] = v;
  return v;
}

// Allow the kernel `bytes` of dynamic shared memory (the most asked for
// so far, per device).
cudaError_t allow_smem(int device, int bytes) {
  static int done[MAX_DEVICES] = {};
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (bytes <= 48 * 1024 || (cached && done[device] >= bytes))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      gibbs_flip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && cached) done[device] = bytes;
  return e;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The most columns K the kernel takes on CUDA device `device`: its
// per-column arrays beside a BC-column pass (7808 with an H100's 227 KiB).
extern "C" int gibbs_flip_max_k(int device) {
  const long room =
      smem_limit(device) - RING_BYTES - fixed_bytes(0, BC);
  return (int)(room / 16);
}

// X (N,D), Z (N,K), A (K,D), lpi (K), act (K), u (N,K) float32 on CUDA
// device `device`; inv2s2 a device scalar; G: scratch of K*K float64;
// Zout (N,K) output. Returns the CUDA error of the launches (0 on
// success; cudaErrorInvalidValue for K > gibbs_flip_max_k(device)).
extern "C" int gibbs_flip_launch(int device, const float* X, const float* Z,
                                 const float* A, const float* lpi,
                                 const float* act, const float* u,
                                 const float* inv2s2, double* G, float* Zout,
                                 int N, int D, int K, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (N <= 0 || K <= 0) return 0;
  if (K > gibbs_flip_max_k(device)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan(K, smem_limit(device));
  e = allow_smem(device, p.bytes);
  if (e != cudaSuccess) return (int)e;
  const bool vx = D % 4 == 0 && aligned16(X), va = D % 4 == 0 && aligned16(A);
  gibbs_gram_kernel<<<dim3(K, (K + NW - 1) / NW), THREADS, K * sizeof(int),
                      stream>>>(A, act, G, K, D, va);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gibbs_flip_kernel<<<(N + BM - 1) / BM, THREADS, p.bytes, stream>>>(
      X, Z, A, lpi, act, u, inv2s2, G, Zout, N, D, K, p, vx, va);
  return (int)cudaGetLastError();
}
