// collapsed_scan: a segment of the collapsed row scan in one launch, the
// hybrid tail's (MH births) or the serial collapsed sweep's (Gibbs births),
// on a packed block of B of the K_can canonical columns.
//
// Replaces the row loop around collapsed_row_flip_pallas
// (src/repro/kernels/collapsed_row/kernel.py:97): the reference's
// _packed_scan (src/repro/core/ibp/collapsed.py:259), one lax.while_loop
// over the rows with lax.cond branches, births by the MH move or by the
// exact truncated Gibbs draw (collapsed.py:132). Its plain version is
// kernels/collapsed_scan/ref.py, whose docstring gives the row step, the
// block and the two flip flavors:
//   * mean form (launch flag fast = 0, instances FAST = false):
//     collapsed_row_recurrence, a block reduction over D per bit (the
//     reference's "pallas");
//   * rss form (fast = 1): collapsed_row_recurrence_rss, O(K) a bit in one
//     warp, reading G = HH' that the scan carries across rows (the
//     reference's "fast" with carry_g): built by a Gram product at every
//     exact factorization, moved by the symmetric rank-two correction of
//     linalg.g_rank1 at the removal and the add-back, each from the
//     pre-move H, masked at drops and at the identity swaps of new slots.
//     The D-length work of the flip moves to the row's entry (rss and
//     rH = H(x - mean)) and exit (mean = zH). After a plain removal the
//     entry is closed-form, x - mean = -(1 + q) b with b = zH - x, from
//     the b.b and Hb that G's removal move computes; the add-back's
//     b_add = x - mean and its b.b is the birth move's rss: two
//     reductions over D a row, and a K.D product at a changed row.
//
// The block: the carry and the statistics live on B columns, cols
// (ascending, the live ones and the lowest free slots); Z and the draws
// stay canonical (K_can wide) and a row's bits and uniforms are gathered
// through cols, its new bits scattered back the same way. A birth draw
// sees the canonical free capacity (the K_can - B out-of-block slots are
// free); a birth the block cannot place where the canonical rule would
// (fewer free slots than j_new, or one at or above min_out, the smallest
// out-of-block index) ends the segment before its row is committed, and
// counts[2] reports that row (-1 when the segment reached the last row).
//
// What bounds it on the H100: neither bytes nor operations but the chain
// of dependent rows. The scan reads X and the draws once and does a few
// hundred kFLOP per row, yet row n+1's carry is row n's result, so the
// rows run one after another, each a chain of block barriers and
// reductions over D. The design therefore spends nothing between rows:
//   * one block of 256 threads walks every row, so there is no launch and
//     no host sync per row;
//   * C independent chains (the multichain sampler's tails) are C blocks
//     of one launch (instances of their own, CHAINED), each on its own
//     SM, so they take about the wall time of one: a single chain leaves
//     the other SMs idle;
//   * the carry (Lt, M, H, G, their row-removed copies, ZtZ, ZtX, m,
//     active and the row's vectors) stays in shared memory when it fits
//     (about 3 B D + 9 B^2 + 2 D floats and two row stages: 224 KB at
//     B=16, D=1024), else in a global scratch the wrapper allocates
//     (L2-resident);
//   * rows of X, their gathered draws and old bits stream through a ring
//     of two shared-memory stages with cp.async, row n+1 loading while row
//     n runs (shared-memory layout only; the global layout reads them
//     where they lie);
//   * every branch of the row step (the refresh, the downdate test, the
//     drift probe, drop masking, the flip, the births, the overflow exit,
//     the add-back and its identity swaps) is block-uniform, decided by
//     every thread from the same values, and the counters are registers
//     written once; the birth move and the flip flavor are block-uniform
//     flags of the launch;
//   * K-length dot products are recomputed by every thread (no barrier),
//     D-length ones are warp or block reductions.
// Sums are taken in another order than the plain version's, so decisions
// may differ from it only at float-boundary events.
//
// Row phases (TRACE instances, the hybrid tail's: MH births, rss flip,
// carry in shared memory, chained or not): thread 0 reads clock64() at
// barriers that bound each phase of the row loop, sums the cycles in
// registers and adds them once, at the end, to a chain's row of the
// int64 buffer ``cycles``: moves (the row's entry and exit: removal and
// add-back moves of the factor and of G, the downdate test, the drift
// probe), the exact refresh, the flips, the births (the MH proposal,
// acceptance and placement), the launch's total, and the rows it
// entered. They add a barrier before the refresh test and one after the
// flips; the arithmetic is the other instances'. A launch without a
// buffer runs those, unchanged.
#include <cuda_runtime.h>

#include "collapsed_row.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int NSTAGE = 2;       // row ring depth
constexpr int J_MAX = 4;        // ref.J_MAX: per-row new-dish truncation
constexpr int NG = J_MAX + 1;   // Gumbel values per row (Gibbs births)
constexpr int PROBE_EVERY = 4;  // ref.PROBE_EVERY: drift-probe cadence

// K-vectors of the row step, slots in the arena (K = the block width B)
enum KVec {
  kAct, kM, kZold, kMminus, kZu, kW, kP, kDrop, kZ, kActm, kV, kProbe,
  kZ2, kNew, kW2, kPup, kTmp, kU, kRH, kHv, kCols, kBc,
  kRq, kNKVec = kRq + 2  // kRq is 2K long
};
// D-vectors: zH (then b_add) and mean (also the probe's active_m H1)
enum DVec { kZH, kMean, kNDVec };

__host__ __device__ inline long round4(long n) { return (n + 3) / 4 * 4; }

// Offsets (floats) of the carry and, with a ring, of the row stages.
struct Layout {
  long Lt, Lt1, M, M1, G, G1, ZtZ, W, Y, H, H1, ZtX, kv, kstride, dv,
      dstride, ring, stage, total;
};

__host__ __device__ inline Layout layout(int K, int D, bool ring) {
  Layout L;
  const long kk = round4((long)K * K), kd = round4((long)K * D);
  long o = 0;
  L.Lt = o, o += kk;
  L.Lt1 = o, o += kk;
  L.M = o, o += kk;
  L.M1 = o, o += kk;
  L.G = o, o += kk;
  L.G1 = o, o += kk;
  L.ZtZ = o, o += kk;
  L.W = o, o += kk;
  L.Y = o, o += kk;
  L.H = o, o += kd;
  L.H1 = o, o += kd;
  L.ZtX = o, o += kd;
  L.kstride = round4(K);
  L.kv = o, o += kNKVec * L.kstride;
  L.dstride = round4(D);
  L.dv = o, o += kNDVec * L.dstride;
  // a stage: x (D), u (K), old bits (K), then j_prop and log_u_acc (MH)
  // or NG Gumbel values from the third slot on (Gibbs), padded to 8
  L.stage = L.dstride + 2 * L.kstride + 8;
  L.ring = o;
  if (ring) o += NSTAGE * L.stage;
  L.total = o;
  return L;
}

// Lt_out = the transposed-layout rank-one Cholesky move of Lt_in by p
// (linalg._chol_rank1_t; sigma = +1 update, -1 downdate, eps 1e-12).
// Lt_out may be Lt_in: each column is one thread's, walked from the
// bottom, reading each entry before writing it. rq holds 2K floats.
// Ends with a barrier.
__device__ void chol_rank1_t(const float* Lt_in, const float* p, float sigma,
                             float* Lt_out, float* rq, int K) {
  const float eps = 1e-12f;
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int j = 0; j < K; ++j) {
      const float p2 = p[j] * p[j];
      c += p2;
      float d = 1.f + sigma * c;
      float dp = d - sigma * p2;
      d = d < eps ? eps : d;  // keeps a NaN, as torch.clamp does
      dp = dp < eps ? eps : dp;
      rq[j] = sqrtf(d / dp);
      rq[K + j] = sigma * p[j] / sqrtf(d * dp);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float S = 0.f;  // sum over rows below i of p_row Lt[row, c]
    for (int i = K - 1; i >= 0; --i) {
      const float l = Lt_in[(long)i * K + c];
      Lt_out[(long)i * K + c] = l * rq[i] + S * rq[K + i];
      S += p[i] * l;
    }
  }
  __syncthreads();
}

// The exact factor (ref._exact_factor) of the statistics (ZtZ, ZtX),
// with row (zrm, x) taken out when ``remove``: W = padded W, L = chol(W)
// in W's lower triangle, Y = L^{-1}, M = (Y^T Y) masked, Lt = L^T,
// H = M (ZtX * act). tmp holds K floats. Ends with a barrier.
__device__ void exact_factor(const float* ZtZ, const float* ZtX,
                             const float* act, const float* zrm,
                             const float* x, bool remove, float ratio,
                             float* W, float* Y, float* tmp, float* Lt,
                             float* M, float* H, int K, int D) {
  const int tid = threadIdx.x;
  const int KK = K * K;
  for (int e = tid; e < KK; e += THREADS) {
    const int i = e / K, j = e % K;
    float s = ZtZ[e];
    if (remove) s = s - zrm[i] * zrm[j];
    const float m2 = act[i] * act[j];
    float w = s * m2;
    if (i == j) w = w + ratio * m2 + (1.f - act[i]);
    W[e] = w;
  }
  __syncthreads();
  // Cholesky by columns (left-looking): column j from the finished ones
  for (int j = 0; j < K; ++j) {
    for (int i = j + tid; i < K; i += THREADS) {
      float s = W[(long)i * K + j];
      for (int k = 0; k < j; ++k) s -= W[(long)i * K + k] * W[(long)j * K + k];
      tmp[i] = s;
    }
    __syncthreads();
    const float djj = sqrtf(tmp[j]);
    for (int i = j + tid; i < K; i += THREADS)
      W[(long)i * K + j] = i == j ? djj : tmp[i] / djj;
    __syncthreads();
  }
  // Y = L^{-1}: column c by forward substitution
  for (int c = tid; c < K; c += THREADS) {
    for (int i = 0; i < c; ++i) Y[(long)i * K + c] = 0.f;
    for (int i = c; i < K; ++i) {
      float s = i == c ? 1.f : 0.f;
      for (int k = c; k < i; ++k) s -= W[(long)i * K + k] * Y[(long)k * K + c];
      Y[(long)i * K + c] = s / W[(long)i * K + i];
    }
  }
  __syncthreads();
  for (int e = tid; e < KK; e += THREADS) {
    const int i = e / K, j = e % K;
    float s = 0.f;
    for (int k = i > j ? i : j; k < K; ++k)
      s += Y[(long)k * K + i] * Y[(long)k * K + j];
    M[e] = s * (act[i] * act[j]);
    Lt[e] = j >= i ? W[(long)j * K + i] : 0.f;
  }
  __syncthreads();
  for (int i = 0; i < K; ++i)
    for (int d = tid; d < D; d += THREADS) {
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        float t = ZtX[(long)k * D + d];
        if (remove) t = t - zrm[k] * x[d];
        s += M[(long)i * K + k] * (t * act[k]);
      }
      H[(long)i * D + d] = s;
    }
  __syncthreads();
}

// A lane's share of sum_d a[d] b(d), d = lane (mod 32), in four
// independent partial sums so that the loads and FMAs of a long D
// overlap instead of forming one chain.
template <typename F>
__device__ __forceinline__ float lane_dot(const float* a, F b, int D) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int d = threadIdx.x & 31;
  for (; d + 96 < D; d += 128) {
    s0 += a[d] * b(d);
    s1 += a[d + 32] * b(d + 32);
    s2 += a[d + 64] * b(d + 64);
    s3 += a[d + 96] * b(d + 96);
  }
  for (; d < D; d += 32) s0 += a[d] * b(d);
  return (s0 + s1) + (s2 + s3);
}

// out[k] = sum_d A[k, d] b(d) for k < K: one warp a row, a butterfly warp
// sum. The caller puts a barrier before out is read.
template <typename F>
__device__ __forceinline__ void rows_dot(const float* A, F b, float* out,
                                         int K, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < K; k += NW) {
    const float s = warp_sum(lane_dot(A + (long)k * D, b, D));
    if (lane == 0) out[k] = s;
  }
}

// G = H H' (K,K), both triangles from one warp sum per pair, so G is
// exactly symmetric. Ends with a barrier.
__device__ void gram(const float* H, float* G, int K, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < K * K; e += NW) {
    const int i = e / K, j = e % K;
    if (j < i) continue;  // warp-uniform
    const float* hj = H + (long)j * D;
    const float s =
        warp_sum(lane_dot(H + (long)i * D, [&](int d) { return hj[d]; }, D));
    if (lane == 0) {
      G[(long)i * K + j] = s;
      G[(long)j * K + i] = s;
    }
  }
  __syncthreads();
}

// One entry of linalg.g_rank1's correction a c' + c a': the same rounded
// products added in either order, so entries (i, j) and (j, i) are equal.
__device__ __forceinline__ float sym2(float ai, float cj, float ci,
                                      float aj) {
  return __fadd_rn(__fmul_rn(ai, cj), __fmul_rn(ci, aj));
}

// c_k = (H b)_k + (b.b)/2 a_k of linalg.g_rank1, one explicitly rounded
// expression, so every thread gets the same bits for the same k.
__device__ __forceinline__ float g_c(float hb, float half_bb, float a) {
  return __fmaf_rn(half_bb, a, hb);
}

// Copy row r's x, gathered draws and old bits into ring stage st
// (cp.async): the MH draws, or the Gibbs births' Gumbel values when
// ``gibbs``. u and Z are canonical, K_can wide; cols picks the block.
__device__ __forceinline__ void prefetch_row(
    float* st, const Layout& L, const float* X, const float* Z,
    const float* u_logit, const float* j_prop, const float* log_u_acc,
    const float* gumbel, const int* cols, bool gibbs, long r, int K,
    int K_can, int D) {
  const int tid = threadIdx.x;
  for (int d = tid; d < D; d += THREADS)
    cp_async4(st + d, X + r * D + d);
  float* su = st + L.dstride;
  float* sz = su + L.kstride;
  for (int i = tid; i < K; i += THREADS) {
    cp_async4(su + i, u_logit + r * K_can + cols[i]);
    cp_async4(sz + i, Z + r * K_can + cols[i]);
  }
  float* tail = sz + L.kstride;
  if (gibbs) {
    if (tid < NG) cp_async4(tail + 2 + tid, gumbel + r * NG + tid);
  } else if (tid == 0) {
    cp_async4(tail, j_prop + r);
    cp_async4(tail + 1, log_u_acc + r);
  }
}

// One block scans rows start_row.. of the segment. CHAINED: a launch of C
// blocks scans C independent chains (the hybrid tails of C chains, MH
// births at the full width), blockIdx.x the chain; its own instances, so
// that a single chain's launch runs the code it ran before the chain axis
// (the moved pointers would hold registers through the row loop that the
// kernel's parameters do not). RING: the carry is in
// dynamic shared memory and rows stream through the ring; otherwise the
// carry is the global scratch ``arena`` and rows are read where they lie,
// and (``stage_rec``) the rss pass reads M1, G1, v, rH and z from a copy
// in dynamic shared memory. FAST: the rss flip with the carried G, else
// the mean form (each flavor its own instance, so the mean form carries
// no code of the other).
template <bool RING, bool FAST, bool CHAINED, bool TRACE>
__global__ void __launch_bounds__(THREADS)
collapsed_scan_kernel(float* __restrict__ Z, float* __restrict__ active_io,
                      float* __restrict__ ZtZ_io, float* __restrict__ ZtX_io,
                      float* __restrict__ m_io, const float* __restrict__ X,
                      const float* __restrict__ u_logit,
                      const float* __restrict__ j_prop,
                      const float* __restrict__ log_u_acc,
                      const float* __restrict__ gumbel,
                      const float* __restrict__ sx_p,
                      const float* __restrict__ sa_p,
                      const float* __restrict__ alpha_p,
                      const long long* __restrict__ cols_g,
                      int* __restrict__ counts, float* __restrict__ arena_g,
                      int n_rows, int K_can, int K, int D, int start_row,
                      float N, int refresh_every, float drift_tol, bool gibbs,
                      bool stage_rec,
                      unsigned long long* __restrict__ cycles) {
  constexpr bool fast = FAST;
  // chain c's buffers: each per-chain input is C copies stacked
  // chain-major, so a pointer moves by c times one chain's extent; cols
  // is shared, and a chained launch takes no Gibbs births (the launcher
  // refuses them)
  if constexpr (CHAINED) {
    const long c = blockIdx.x;
    Z += c * n_rows * K_can;
    u_logit += c * n_rows * K_can;
    X += c * n_rows * D;
    active_io += c * K;
    m_io += c * K;
    ZtZ_io += c * K * K;
    ZtX_io += c * K * D;
    j_prop += c * n_rows;
    log_u_acc += c * n_rows;
    sx_p += c;
    sa_p += c;
    counts += 3 * c;
    if constexpr (!RING) arena_g += c * layout(K, D, false).total;
    if constexpr (TRACE) cycles += 6 * c;
  }
  // TRACE: thread 0's cycles by phase (see the top of the file)
  long long t_begin = 0, t_mark = 0, c_move = 0, c_refresh = 0, c_flip = 0,
            c_birth = 0;
  auto mark = [&](long long& phase) {
    if constexpr (TRACE) {
      if (threadIdx.x == 0) {
        const long long t = clock64();
        phase += t - t_mark;
        t_mark = t;
      }
    }
  };
  if constexpr (TRACE) {
    if (threadIdx.x == 0) t_begin = clock64();
  }
  extern __shared__ float4 sh4[];
  __shared__ float red[2 * NW];
  float* arena = RING ? reinterpret_cast<float*>(sh4) : arena_g;
  const Layout L = layout(K, D, RING);
  float* Lt = arena + L.Lt;
  float* Lt1 = arena + L.Lt1;
  float* M = arena + L.M;
  float* M1 = arena + L.M1;
  float* G = arena + L.G;
  float* G1 = arena + L.G1;
  float* ZtZ = arena + L.ZtZ;
  float* W = arena + L.W;
  float* Y = arena + L.Y;
  float* H = arena + L.H;
  float* H1 = arena + L.H1;
  float* ZtX = arena + L.ZtX;
  auto kv = [&](int slot) { return arena + L.kv + slot * L.kstride; };
  float *act = kv(kAct), *m = kv(kM), *zold = kv(kZold),
        *mminus = kv(kMminus), *zu = kv(kZu), *w = kv(kW), *p = kv(kP),
        *drop = kv(kDrop), *z = kv(kZ), *actm = kv(kActm), *v = kv(kV),
        *probe = kv(kProbe), *z2 = kv(kZ2), *nb = kv(kNew), *w2 = kv(kW2),
        *pup = kv(kPup), *tmp = kv(kTmp), *ug = kv(kU), *rH = kv(kRH),
        *hv = kv(kHv), *bc = kv(kBc), *rq = kv(kRq);
  int* cols = reinterpret_cast<int*>(kv(kCols));
  float* zH = arena + L.dv + kZH * L.dstride;  // then b_add
  float* mean = arena + L.dv + kMean * L.dstride;
  const int tid = threadIdx.x;
  const int KK = K * K;

  const float sx = *sx_p, sa = *sa_p;
  const float t_r = sx / sa, t_rho = sa / sx;
  const float ratio = t_r * t_r;
  const float rho = t_rho * t_rho;
  const float inv2s2 = 0.5f / (sx * sx);
  const float sqrt_ratio_m1 = sqrtf(ratio) - 1.f;
  const float halfD = -0.5f * (float)D;
  const float n_out_free = (float)(K_can - K);  // out-of-block: free
  // Gibbs births: lam = alpha / N and its log, as ref._log_poisson reads
  // them; log j! is ref.LOG_FACT rounded to float32
  const float lam = gibbs ? *alpha_p / N : 0.f;
  const float log_lam = gibbs ? logf(lam) : 0.f;
  constexpr float kLogFact[NG] = {0.f, 0.f, 0.693147182f, 1.79175949f,
                                  3.17805386f};

  for (int e = tid; e < KK; e += THREADS) ZtZ[e] = ZtZ_io[e];
  for (int k = 0; k < K; ++k)
    for (int d = tid; d < D; d += THREADS)
      ZtX[(long)k * D + d] = ZtX_io[(long)k * D + d];
  for (int i = tid; i < K; i += THREADS) {
    act[i] = active_io[i];
    m[i] = m_io[i];
    cols[i] = (int)cols_g[i];
  }
  __syncthreads();  // cols visible to the prefetch
  if (RING && start_row < n_rows) {
    prefetch_row(arena + L.ring, L, X, Z, u_logit, j_prop, log_u_acc, gumbel,
                 cols, gibbs, start_row, K, K_can, D);
    cp_async_commit();
  }
  // min_out: the first block index whose column is not its own index
  // (cols ascends), else K (the block is the first K columns)
  int min_out = K;
  for (int i = 0; i < K; ++i)
    if (cols[i] != i) {
      min_out = i;
      break;
    }
  exact_factor(ZtZ, ZtX, act, nullptr, nullptr, false, ratio, W, Y, tmp, Lt,
               M, H, K, D);
  if (fast) gram(H, G, K, D);
  if constexpr (TRACE) {
    if (tid == 0) t_mark = clock64();
  }

  int since = 0, n_refresh = 0, n_sat = 0, ovf_row = -1;
  for (int n = start_row; n < n_rows; ++n) {
    // ---- the row: x, draws and old bits (ring stage or where they lie)
    const float *x, *u, *zsrc, *g = nullptr;
    float jp = 0.f, lua = 0.f;
    if (RING) {
      if (n + 1 < n_rows)
        prefetch_row(arena + L.ring + ((n + 1 - start_row) % NSTAGE) * L.stage,
                     L, X, Z, u_logit, j_prop, log_u_acc, gumbel, cols, gibbs,
                     n + 1, K, K_can, D);
      cp_async_commit();  // an empty group on the last row
      cp_async_wait<1>();
      __syncthreads();
      const float* st = arena + L.ring + ((n - start_row) % NSTAGE) * L.stage;
      x = st;
      u = st + L.dstride;
      zsrc = u + L.kstride;
      const float* tail = zsrc + L.kstride;
      if (gibbs) {
        g = tail + 2;
      } else {
        jp = tail[0];
        lua = tail[1];
      }
    } else {
      x = X + (long)n * D;
      for (int i = tid; i < K; i += THREADS)
        ug[i] = u_logit[(long)n * K_can + cols[i]];
      u = ug;  // visible after the barrier below
      zsrc = nullptr;
      if (gibbs) {
        g = gumbel + (long)n * NG;
      } else {
        jp = j_prop[n];
        lua = log_u_acc[n];
      }
    }

    // ---- remove row n: masks and counts
    for (int i = tid; i < K; i += THREADS) {
      const float zo =
          RING ? zsrc[i] : Z[(long)n * K_can + cols[i]];
      const float mm = m[i] - zo;
      const float dr = act[i] * (mm <= 0.5f ? 1.f : 0.f);
      zold[i] = zo;
      mminus[i] = mm;
      zu[i] = zo * act[i];
      drop[i] = dr;
      z[i] = zo * (1.f - dr);
      actm[i] = act[i] * (1.f - dr);
    }
    __syncthreads();
    // w = M zu, zH = zu H
    for (int i = tid; i < K; i += THREADS) {
      float s = 0.f;
      for (int j = 0; j < K; ++j) s += M[(long)i * K + j] * zu[j];
      w[i] = s;
    }
    for (int d = tid; d < D; d += THREADS) {
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += zu[k] * H[(long)k * D + d];
      zH[d] = s;
    }
    __syncthreads();
    float gamma = 0.f;
    bool has_drop = false;
    for (int k = 0; k < K; ++k) {
      gamma += zu[k] * w[k];
      has_drop |= drop[k] > 0.5f;
    }
    const float omg = 1.f - gamma;
    const float delta_s = omg < 1e-6f ? 1e-6f : omg;
    const float sq_delta = sqrtf(delta_s);
    const bool probe_row = since % PROBE_EVERY == 0;
    float half_bb = 0.f;
    if (fast) {
      // G's removal move from the pre-move H: c = H b + (b.b)/2 wd with
      // b = zH - x (linalg.g_rank1)
      float bp = 0.f;
      for (int d = tid; d < D; d += THREADS) {
        const float b = zH[d] - x[d];
        bp += b * b;
      }
      rows_dot(H, [&](int d) { return zH[d] - x[d]; }, hv, K, D);
      half_bb = 0.5f * block_sum<float, NW>(bp, red);  // hv visible too
    }
    float dz_act = 0.f;  // z_old . active_m
    if (probe_row)
      for (int k = 0; k < K; ++k) dz_act += zold[k] * actm[k];
    // p = Lt w; M1, H1 (and G1): the row-removed factor, masked to active_m
    const float q_closed = gamma / delta_s;
    for (int i = tid; i < K; i += THREADS) {
      float s = 0.f;
      for (int j = 0; j < K; ++j) s += Lt[(long)i * K + j] * w[j];
      p[i] = s;
      if (fast) {  // the rss flip's entry rH after a plain removal:
        // H1 b = actm (hv + (b.b) wd), rH = -(1 + q) H1 b; the entry
        // recomputes it after a drop or a refresh
        const float s1 = 1.f + q_closed;
        rH[i] = -s1 * (actm[i] * (hv[i] + 2.f * half_bb * (w[i] / delta_s)));
      }
      if (probe_row) {
        float t = 0.f;
        for (int j = 0; j < K; ++j) t += ZtZ[(long)i * K + j] * actm[j];
        t = t - zold[i] * dz_act;
        probe[i] = actm[i] * t + ratio * actm[i];
      }
    }
    for (int e = tid; e < KK; e += THREADS) {
      const int i = e / K, j = e % K;
      const float wri = w[i] / sq_delta, wrj = w[j] / sq_delta;
      const float keep = actm[i] * actm[j];
      M1[e] = (M[e] + wri * wrj) * keep;
      if (fast) {
        const float ai = w[i] / delta_s, aj = w[j] / delta_s;
        G1[e] = (G[e] + sym2(ai, g_c(hv[j], half_bb, aj),
                             g_c(hv[i], half_bb, ai), aj)) *
                keep;
      }
    }
    for (int k = 0; k < K; ++k) {
      const float wdk = w[k] / delta_s, ak = actm[k];
      const float* Hk = H + (long)k * D;
      float* H1k = H1 + (long)k * D;
      for (int d = tid; d < D; d += THREADS)
        H1k[d] = (Hk[d] + wdk * (zH[d] - x[d])) * ak;
    }
    __syncthreads();
    bool down_ok = true;
    {
      float c = 0.f;
      for (int k = 0; k < K; ++k) {
        c += p[k] * p[k];
        down_ok &= (1.f - c) > 1e-12f;
      }
    }
    bool drift_ok = true;
    if (probe_row) {  // ‖M1 W p − p‖∞ against the exact statistics
      for (int i = tid; i < K; i += THREADS) {
        float s = 0.f;
        for (int j = 0; j < K; ++j) s += M1[(long)i * K + j] * probe[j];
        tmp[i] = fabsf(s - actm[i]);
      }
      if (fast)  // active_m H1, into the mean buffer (free until the flip)
        for (int d = tid; d < D; d += THREADS) {
          float s = 0.f;
          for (int k = 0; k < K; ++k) s += actm[k] * H1[(long)k * D + d];
          mean[d] = s;
        }
      __syncthreads();
      float dm = tmp[0];
      for (int k = 1; k < K; ++k)
        dm = (tmp[k] > dm || tmp[k] != tmp[k]) ? tmp[k] : dm;
      drift_ok = dm <= drift_tol;
      if (fast) {
        // ‖G1 a − H1 (a H1)‖∞ / (1 + max|G1|), a = active_m
        rows_dot(H1, [&](int d) { return mean[d]; }, hv, K, D);
        float gm = 0.f;
        for (int e = tid; e < KK; e += THREADS) {
          const float a = fabsf(G1[e]);
          gm = (a > gm || a != a) ? a : gm;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float b = __shfl_xor_sync(0xffffffffu, gm, o);
          gm = (b > gm || b != b) ? b : gm;
        }
        __syncthreads();  // tmp read by every thread; hv written
        if ((tid & 31) == 0) red[tid >> 5] = gm;
        for (int i = tid; i < K; i += THREADS) {
          float s = 0.f;
          for (int j = 0; j < K; ++j) s += G1[(long)i * K + j] * actm[j];
          tmp[i] = fabsf(s - hv[i]);
        }
        __syncthreads();
        gm = red[0];
        for (int k = 1; k < NW; ++k)
          gm = (red[k] > gm || red[k] != red[k]) ? red[k] : gm;
        float dg = tmp[0];
        for (int k = 1; k < K; ++k)
          dg = (tmp[k] > dg || tmp[k] != tmp[k]) ? tmp[k] : dg;
        drift_ok = drift_ok && (dg / (1.f + gm) <= drift_tol);
      }
      __syncthreads();  // tmp, red free again
    }
    if constexpr (TRACE) __syncthreads();
    mark(c_move);  // entry, removal, downdate test, probe
    const bool need = since >= refresh_every - 1 || !down_ok || !drift_ok;
    if (need) {  // exact refresh from the row-removed statistics
      exact_factor(ZtZ, ZtX, actm, zold, x, true, ratio, W, Y, tmp, Lt1, M1,
                   H1, K, D);
      if (fast) gram(H1, G1, K, D);
    }
    mark(c_refresh);

    // ---- bit flips: (v, q, mean) by mat-vec after a drop or a refresh,
    // in closed form after a plain removal
    float q;
    if (has_drop || need) {
      for (int i = tid; i < K; i += THREADS) {
        float s = 0.f;
        for (int j = 0; j < K; ++j) s += M1[(long)i * K + j] * z[j];
        v[i] = s;
      }
      for (int d = tid; d < D; d += THREADS) {
        float s = 0.f;
        for (int k = 0; k < K; ++k) s += z[k] * H1[(long)k * D + d];
        mean[d] = s;
      }
      __syncthreads();
      q = 0.f;
      for (int k = 0; k < K; ++k) q += z[k] * v[k];
    } else {
      q = q_closed;
      for (int i = tid; i < K; i += THREADS) v[i] = w[i] / delta_s;
      if (!fast)  // the rss flip's entry is closed-form here
        for (int d = tid; d < D; d += THREADS)
          mean[d] = zH[d] + q * (zH[d] - x[d]);
      __syncthreads();
    }
    if (fast) {
      // entry: rss = |x - mean|^2, rH = H1 (x - mean), closed-form after
      // a plain removal (rH written with p); the pass; exit: mean = z H1
      float rss0;
      if (has_drop || need) {
        float rp = 0.f;
        for (int d = tid; d < D; d += THREADS) {
          const float r = x[d] - mean[d];
          rp += r * r;
        }
        rows_dot(H1, [&](int d) { return x[d] - mean[d]; }, rH, K, D);
        rss0 = block_sum<float, NW>(rp, red);  // rH visible too
      } else {
        const float s1 = 1.f + q;
        rss0 = s1 * s1 * (2.f * half_bb);
      }
      if (!RING && stage_rec) {
        // the pass reads a row of M1 and of G1 a bit: from shared memory
        float* sM = reinterpret_cast<float*>(sh4);
        float* sG = sM + KK;
        float* sv = sG + KK;
        float* sr = sv + K;
        float* sz = sr + K;
        for (int e = tid; e < KK; e += THREADS) {
          sM[e] = M1[e];
          sG[e] = G1[e];
        }
        for (int i = tid; i < K; i += THREADS) {
          sv[i] = v[i];
          sr[i] = rH[i];
          sz[i] = z[i];
        }
        __syncthreads();
        collapsed_row_recurrence_rss(sM, sG, sv, sr, sz, q, rss0, u, mminus,
                                     actm, N, inv2s2, K, D, bc);
        for (int i = tid; i < K; i += THREADS) z[i] = sz[i];
        __syncthreads();
      } else {
        collapsed_row_recurrence_rss(M1, G1, v, rH, z, q, rss0, u, mminus,
                                     actm, N, inv2s2, K, D, bc);
      }
      for (int d = tid; d < D; d += THREADS) {
        float s = 0.f;
        for (int k = 0; k < K; ++k) s += z[k] * H1[(long)k * D + d];
        mean[d] = s;
      }
    } else {
      collapsed_row_recurrence<THREADS>(M1, H1, x, mean, v, z, q, u, mminus,
                                        actm, N, inv2s2, K, D, red);
    }
    if constexpr (TRACE) __syncthreads();
    mark(c_flip);

    // ---- new dishes (ref._sample_dishes): the canonical free capacity.
    // The rss flip's add-back reads b_add = x - mean (= x - z2 H1: the rows
    // of H1 at new bits are 0), kept in zH.
    float rp = 0.f;
    for (int d = tid; d < D; d += THREADS) {
      const float r = x[d] - mean[d];
      rp += r * r;
      if (fast) zH[d] = r;
    }
    const float rss = block_sum<float, NW>(rp, red);
    bool moved = false, mask_moved = false, any_new = false, sat = false;
    float n_new = 0.f, j_new;
    int top_col = -1;
    {
      const float s = 1.f + q;
      float ll[J_MAX + 1];
#pragma unroll
      for (int j = 0; j <= J_MAX; ++j) {
        const float sj = s + __fmul_rn((float)j, rho);  // as js * rho
        ll[j] = halfD * logf(sj) - inv2s2 * rss / sj;
      }
      float n_free = 0.f;
      for (int k = 0; k < K; ++k) n_free += 1.f - fmaxf(actm[k], z[k]);
      n_free = n_free + n_out_free;
      if (gibbs) {
        // exact truncated Gibbs: the first argmax over j <= n_free of
        // log Poisson(j; lam) + ll_j + g_j (a categorical draw); the
        // other j are -inf in the plain version and never taken
        int jb = 0;
        float best = 0.f;
#pragma unroll
        for (int j = 0; j <= J_MAX; ++j) {
          const float lp = __fsub_rn(
              __fsub_rn(__fmul_rn((float)j, log_lam), lam), kLogFact[j]);
          const float val = __fadd_rn(g[j], __fadd_rn(lp, ll[j]));
          if ((float)j <= n_free && (j == 0 || val > best)) {
            best = val;
            jb = j;
          }
        }
        j_new = (float)jb;
      } else {
        const float cap = n_free < (float)J_MAX ? n_free : (float)J_MAX;
        const bool ok = jp <= cap;
        const float jc = jp < 0.f ? 0.f : (jp > (float)J_MAX ? J_MAX : jp);
        const float dll = ll[(int)jc] - ll[0];
        const bool acc = lua < dll;
        j_new = (ok && acc) ? jp : 0.f;
        sat = acc && jp <= (float)J_MAX && jp > n_free;
      }
      float rank = 0.f;  // running count of free slots
      for (int k = 0; k < K; ++k) {
        const float fr = 1.f - fmaxf(actm[k], z[k]);
        rank += fr;
        const float frk = rank * fr;
        const float b = (frk >= 1.f && frk <= j_new) ? 1.f : 0.f;
        const float zk2 = z[k] + b;
        const float ak2 = fmaxf(actm[k], b);
        moved |= zk2 != zold[k];
        mask_moved |= ak2 != act[k];
        any_new |= b > 0.5f;
        n_new += b;
        if (b > 0.5f) top_col = cols[k];
        if (k % THREADS == tid) {
          z2[k] = zk2;
          nb[k] = b;
        }
      }
    }
    // a birth the block cannot place where the canonical rule would: stop
    // before committing the row (block-uniform)
    if (n_new < j_new || top_col >= min_out) {
      ovf_row = n;
      mark(c_birth);
      break;
    }
    const bool changed = need || moved || mask_moved;
    since = need ? 0 : since + 1;
    n_refresh += need ? 1 : 0;
    n_sat += sat ? 1 : 0;
    __syncthreads();  // z2, nb visible; act, m may move from here
    mark(c_birth);

    // ---- add row n back: statistics, then the factor
    if (has_drop) {
      for (int e = tid; e < KK; e += THREADS) {
        const int i = e / K, j = e % K;
        ZtZ[e] = (ZtZ[e] - zold[i] * zold[j]) * (actm[i] * actm[j]) +
                 z2[i] * z2[j];
      }
      for (int k = 0; k < K; ++k) {
        float* row = ZtX + (long)k * D;
        for (int d = tid; d < D; d += THREADS)
          row[d] = (row[d] - zold[k] * x[d]) * actm[k] + z2[k] * x[d];
      }
    } else if (changed) {
      for (int e = tid; e < KK; e += THREADS) {
        const int i = e / K, j = e % K;
        ZtZ[e] = ZtZ[e] + z2[i] * z2[j] - zold[i] * zold[j];
      }
      for (int k = 0; k < K; ++k) {
        const float dz = z2[k] - zold[k];
        if (dz == 0.f) continue;  // adds exact zeros
        float* row = ZtX + (long)k * D;
        for (int d = tid; d < D; d += THREADS) row[d] = row[d] + dz * x[d];
      }
    }
    if (changed) {
      if (!need) chol_rank1_t(Lt, p, -1.f, Lt1, rq, K);
      if (has_drop || any_new) {  // identity swaps of dropped/born slots
        for (int e = tid; e < KK; e += THREADS) {
          const int i = e / K, j = e % K;
          float l = Lt1[e] * (actm[i] * actm[j]);
          if (i == j) {
            l = l + (1.f - actm[i]);
            l = l + nb[i] * sqrt_ratio_m1;
            M1[e] = M1[e] + nb[i] / ratio;
          }
          Lt1[e] = l;
          if (fast) G1[e] = G1[e] * ((1.f - nb[i]) * (1.f - nb[j]));
        }
        for (int k = 0; k < K; ++k) {
          if (nb[k] == 0.f) continue;  // a factor of exactly 1
          float* row = H1 + (long)k * D;
          for (int d = tid; d < D; d += THREADS) row[d] = row[d] * 0.f;
        }
        __syncthreads();
      }
      // w2 = M1 z2, b_add = x - z2 H1 (the rss flip's is in zH already)
      for (int i = tid; i < K; i += THREADS) {
        float s = 0.f;
        for (int j = 0; j < K; ++j) s += M1[(long)i * K + j] * z2[j];
        w2[i] = s;
      }
      if (!fast)
        for (int d = tid; d < D; d += THREADS) {
          float s = 0.f;
          for (int k = 0; k < K; ++k) s += z2[k] * H1[(long)k * D + d];
          zH[d] = x[d] - s;
        }
      __syncthreads();
      for (int i = tid; i < K; i += THREADS) {
        float s = 0.f;
        for (int j = 0; j < K; ++j) s += Lt1[(long)i * K + j] * w2[j];
        pup[i] = s;
      }
      // G's add-back move from the pre-move H1: c = H1 b_add + (b_add .
      // b_add)/2 a, the latter the birth move's rss
      if (fast) {
        rows_dot(H1, [&](int d) { return zH[d]; }, hv, K, D);
        half_bb = 0.5f * rss;
      }
      __syncthreads();
      chol_rank1_t(Lt1, pup, 1.f, Lt, rq, K);
      float d2 = 0.f;
      for (int k = 0; k < K; ++k) d2 += z2[k] * w2[k];
      d2 = 1.f + d2;
      const float sq_d2 = sqrtf(d2);
      for (int e = tid; e < KK; e += THREADS) {
        const int i = e / K, j = e % K;
        M[e] = M1[e] - (w2[i] / sq_d2) * (w2[j] / sq_d2);
        if (fast) {
          const float ai = w2[i] / d2, aj = w2[j] / d2;
          G[e] = G1[e] + sym2(ai, g_c(hv[j], half_bb, aj),
                              g_c(hv[i], half_bb, ai), aj);
        }
      }
      for (int k = 0; k < K; ++k) {
        const float ck = w2[k] / d2;
        const float* H1k = H1 + (long)k * D;
        float* Hk = H + (long)k * D;
        for (int d = tid; d < D; d += THREADS) Hk[d] = H1k[d] + ck * zH[d];
      }
    }
    for (int i = tid; i < K; i += THREADS) {
      Z[(long)n * K_can + cols[i]] = z2[i];
      act[i] = fmaxf(actm[i], nb[i]);
      m[i] = mminus[i] * actm[i] + z2[i];
    }
    __syncthreads();  // end of the row: the carry and the stage are settled
    mark(c_move);  // add-back
  }
  if (RING) {
    cp_async_wait<0>();  // an overflow exit leaves the next row in flight
    __syncthreads();
  }

  for (int e = tid; e < KK; e += THREADS) ZtZ_io[e] = ZtZ[e];
  for (int k = 0; k < K; ++k)
    for (int d = tid; d < D; d += THREADS)
      ZtX_io[(long)k * D + d] = ZtX[(long)k * D + d];
  for (int i = tid; i < K; i += THREADS) {
    active_io[i] = act[i];
    m_io[i] = m[i];
  }
  if (tid == 0) {
    counts[0] = n_refresh;
    counts[1] = n_sat;
    counts[2] = ovf_row;
  }
  if constexpr (TRACE) {
    if (tid == 0) {
      atomicAdd(cycles, (unsigned long long)c_move);
      atomicAdd(cycles + 1, (unsigned long long)c_refresh);
      atomicAdd(cycles + 2, (unsigned long long)c_flip);
      atomicAdd(cycles + 3, (unsigned long long)c_birth);
      atomicAdd(cycles + 4, (unsigned long long)(clock64() - t_begin));
      const int rows = (ovf_row >= 0 ? ovf_row + 1 : n_rows) - start_row;
      atomicAdd(cycles + 5, (unsigned long long)rows);
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The shared memory one block may opt in to, read once per device.
int smem_optin(int device) {
  static int cache[MAX_DEVICES] = {};
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && cache[device] > 0) return cache[device];
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  if (cached) cache[device] = optin;
  return optin;
}

// Bytes of dynamic shared memory the ring layout needs, and whether this
// device grants them to one block (the static reduction slots share the
// block's allowance).
bool ring_fits(int device, int K, int D, size_t* bytes) {
  *bytes = (size_t)layout(K, D, true).total * sizeof(float);
  return *bytes + 2 * NW * sizeof(float) <= (size_t)smem_optin(device);
}

// Raise the ring kernels' dynamic shared memory limit to the device's
// opt-in, once per device, so any layout that fits may launch.
cudaError_t allow_smem(int device) {
  static bool done[MAX_DEVICES] = {};
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && done[device]) return cudaSuccess;
  const int bytes = smem_optin(device) - (int)(2 * NW * sizeof(float));
  decltype(&collapsed_scan_kernel<true, false, false, false>) const ring[] = {
      collapsed_scan_kernel<true, false, false, false>,
      collapsed_scan_kernel<true, true, false, false>,
      collapsed_scan_kernel<true, false, true, false>,
      collapsed_scan_kernel<true, true, true, false>,
      collapsed_scan_kernel<true, true, false, true>,
      collapsed_scan_kernel<true, true, true, true>};
  cudaError_t e = cudaSuccess;
  for (auto kernel : ring)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && cached) done[device] = true;
  return e;
}

// The global layout's copy of M1, G1, v, rH and z for the rss pass, in
// bytes: 0 where it would need more than the 48 KB a block gets without
// opting in (K > 76).
size_t rec_stage_bytes(int K) {
  const size_t bytes = (2 * (size_t)K * K + 3 * (size_t)K) * sizeof(float);
  return bytes + 2 * NW * sizeof(float) <= 48 * 1024 ? bytes : 0;
}

}  // namespace

// Floats of global scratch the kernel needs for a block of K columns, D
// wide, on `device`: 0 when the carry fits in shared memory.
extern "C" long collapsed_scan_scratch_floats(int device, int K, int D) {
  size_t bytes;
  if (ring_fits(device, K, D, &bytes)) return 0;
  return layout(K, D, false).total;
}

// Z (n_rows,K_can): updated in place at the block's columns; active (K),
// ZtZ (K,K), ZtX (K,D), m (K): the block's statistics, updated in place;
// X (n_rows,D), u_logit (n_rows,K_can), sx, sa (device scalars): read;
// cols (K int64, ascending): the block's canonical columns; rows
// start_row..n_rows-1 are scanned; births by MH from j_prop, log_u_acc
// (n_rows) when gibbs is 0, else by Gibbs from gumbel (n_rows, J_MAX+1)
// and alpha (a device scalar), the other pair unread (may be null); the
// flip in mean form (fast 0) or in rss form with the carried G (fast 1);
// counts (3 int32): n_refresh, n_sat, ovf_row; scratch:
// collapsed_scan_scratch_floats(device, K, D) floats. chains > 1 scans C
// independent chains in one launch of C blocks: Z, active, ZtZ, ZtX, m,
// X, u_logit, j_prop, log_u_acc, sx, sa, counts and the scratch are C
// copies stacked chain-major, cols is shared; births by MH only, at the
// full width (K == K_can) from row 0. cycles (C x 6 int64, or null): the
// row phases' cycles are added to it where a TRACE instance exists (MH
// births, fast 1, the carry in shared memory), else the launch runs as
// with null. Returns the CUDA error of the launch (0 on success).
extern "C" int collapsed_scan_launch(
    int device, float* Z, float* active, float* ZtZ, float* ZtX, float* m,
    const float* X, const float* u_logit, const float* j_prop,
    const float* log_u_acc, const float* gumbel, const float* sx,
    const float* sa, const float* alpha, const long long* cols, int* counts,
    float* scratch, int n_rows, int K_can, int K, int D, int start_row,
    float N, int refresh_every, float drift_tol, int gibbs, int fast,
    int chains, void* stream_, unsigned long long* cycles) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (chains < 1 || (chains > 1 && (gibbs || K != K_can || start_row != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  size_t bytes;
  const bool ring = ring_fits(device, K, D, &bytes);
  if (ring) {
    e = allow_smem(device);
    if (e != cudaSuccess) return (int)e;
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    bytes = fast ? rec_stage_bytes(K) : 0;
  }
  const bool trace = cycles != nullptr && ring && fast && !gibbs;
  auto kernel =
      trace ? (chains > 1 ? collapsed_scan_kernel<true, true, true, true>
                          : collapsed_scan_kernel<true, true, false, true>)
      : chains > 1
          ? (ring ? (fast ? collapsed_scan_kernel<true, true, true, false>
                          : collapsed_scan_kernel<true, false, true, false>)
                  : (fast ? collapsed_scan_kernel<false, true, true, false>
                          : collapsed_scan_kernel<false, false, true, false>))
          : (ring ? (fast ? collapsed_scan_kernel<true, true, false, false>
                          : collapsed_scan_kernel<true, false, false, false>)
                  : (fast ? collapsed_scan_kernel<false, true, false, false>
                          : collapsed_scan_kernel<false, false, false, false>));
  kernel<<<chains, THREADS, bytes, stream>>>(
      Z, active, ZtZ, ZtX, m, X, u_logit, j_prop, log_u_acc, gumbel, sx, sa,
      alpha, cols, counts, ring ? nullptr : scratch, n_rows, K_can, K, D,
      start_row, N, refresh_every, drift_tol, gibbs != 0, bytes > 0,
      trace ? cycles : nullptr);
  return (int)cudaGetLastError();
}
