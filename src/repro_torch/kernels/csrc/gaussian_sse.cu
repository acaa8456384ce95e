// gaussian_sse: the masked residual sum of squares |X - (Z*active) A|^2.
//
// Replaces gaussian_sse_pallas (src/repro/kernels/gaussian_sse/kernel.py:28,
// body :17), which fuses mask -> product -> subtract -> square -> reduce
// per row block and accumulates one float32 scalar across its grid.
//
// What bounds it on the H100: bytes. At N=32768, K=64, D=1024, X is
// 128 MiB (about 40 us at 3.35 TB/s). The product P = (Z*active) A is
// 2 N K D = 4.3 GFLOP: about 64 us as float32 multiply-adds on the CUDA
// cores, more than the read of X, but less than it on the tensor cores.
//
// Design:
//   * The product runs on the tensor cores (mma.sync, mma.cuh). Float32
//     inputs as 3xTF32: z and a are split by truncation into hi + lo and
//     zlo*ahi + zhi*alo + zhi*ahi is accumulated in float32 (about 2^-21
//     relative per product). A warp whose masked z are all 0 or 1 has
//     zlo = 0 and takes a branch without that product (tf32_products):
//     the sampler's Z pays for two products, a real-valued Z for three,
//     with bitwise the same sums for a binary Z. Bfloat16 inputs run one
//     m16n8k16 bf16 product per k-step: exact products, float32
//     accumulation.
//   * A block owns BM = 128 rows, 16 per warp, and a range of BN-column
//     tiles (the range is all of D when the row tiles fill the card; D is
//     split across blocks when they do not, e.g. the held-out eval's
//     N = 1024). Its z rows are staged once through shared memory
//     (coalesced copies), masked by active and held as mma A-operand
//     registers (split for float32) for every tile. K beyond 64 is walked
//     in chunks of 64 columns of Z, read from Z per chunk.
//   * A's rows and X's tile stream through a ring of cp.async stages in
//     shared memory, A kept row-major ([k][d]: the TF32 B fragments load
//     conflict-free with a row pitch of 8 mod 32 words, the bf16 ones by
//     ldmatrix.trans), so A needs no transposing pre-pass and is split in
//     the loop. Each block starts its walk over the column tiles at its
//     own offset, so the blocks running together read different tiles of
//     A from L2.
//   * The epilogue reads x at each accumulator's (row, column) from the
//     staged tile and adds (x - p)^2: neither P nor the residual reaches
//     device memory. Rows >= N, columns >= D and k >= K are zero in the
//     staged tiles and the z registers, so they add nothing.
//   * Squares are summed in float32 per tile and in float64 across tiles
//     and the block; the blocks' partial sums go to a buffer and a
//     one-block second pass adds them in a fixed order. No float atomics:
//     repeated calls are bitwise equal. The result is float32.
//
// What holds it back (PERF.md, section 6): the TF32 mma.sync products and
// their B-fragment loads and splits take about as long as the read of X,
// and the two overlap only in part.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int MIN_BLOCKS = 2;  // blocks per SM: registers, shared memory
constexpr int BM = 16 * NW;    // rows of a block, 16 per warp
constexpr int BN = 64;         // columns of a tile
constexpr int LD = BN + 8;     // padded shared row: conflict-free fragments
constexpr int MAX_DEVICES = 64;

// k of one mma step and stages of the ring, by input type
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int KSTEP = 8, NSTAGE = 2;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int KSTEP = 16, NSTAGE = 3;
};

// A stage: KC rows of A, then BM rows of X, each BN wide (pitch LD).
template <typename T, int KC>
constexpr int smem_bytes() {
  return Cfg<T>::NSTAGE * (KC + BM) * LD * (int)sizeof(T);
}

// The products of one chunk, float32: for every k-step and n-tile, A's
// B fragment split into hi/lo, then zl*ahi (when LO) + zh*alo + zh*ahi.
// The kernel takes LO = false, by a warp-uniform branch, for a binary z.
template <bool LO, int KS, int NT>
__device__ __forceinline__ void tf32_products(float (&c)[NT][4],
                                              const uint32_t (&zh)[KS][4],
                                              const uint32_t (&zl)[KS][4],
                                              const float* As, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = As + (ks * 8 + t) * LD + j * 8 + g;
      uint32_t bh[2], bl[2];
      split(b[0], bh[0], bl[0]);
      split(b[4 * LD], bh[1], bl[1]);
      if (LO) mma_tf32(c[j], zl[ks], bh);
      mma_tf32(c[j], zh[ks], bl);
      mma_tf32(c[j], zh[ks], bh);
    }
}

// grid: row tiles x column splits; block b writes partial[b]. A block
// walks ntile column tiles x nkc chunks of KC columns of Z ("steps"); X's
// tile is staged with the tile's last chunk, whose step ends in the
// epilogue.
template <typename T, int KC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sse_mma_kernel(const T* __restrict__ X, const T* __restrict__ Z,
               const T* __restrict__ A, const T* __restrict__ act,
               double* __restrict__ partial, int N, int D, int K,
               int col_splits, int tiles_per_split, bool vx, bool va,
               bool vz) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int NSTAGE = Cfg<T>::NSTAGE;
  constexpr int KS = KC / Cfg<T>::KSTEP;  // mma k-steps of a chunk
  constexpr int NT = BN / 8;              // n-tiles of a tile
  constexpr int SE = (KC + BM) * LD;      // elements of a stage
  static_assert(KC <= LD, "the staged z rows fit the pitch LD");
  extern __shared__ float4 sh4[];
  T* sh = reinterpret_cast<T*>(sh4);
  __shared__ double red[NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ctiles = (D + BN - 1) / BN;
  const long row0 = (long)(blockIdx.x / col_splits) * BM;
  const int ct0 = (blockIdx.x % col_splits) * tiles_per_split;
  const int ntile = min(tiles_per_split, ctiles - ct0);
  const int nkc = max(1, (K + KC - 1) / KC);
  const int nsteps = ntile * nkc;

  // step s: tile (s / nkc + blockIdx.x) % ntile of the block's range,
  // chunk s % nkc
  auto load = [&](int s) {
    T* st = sh + (s % NSTAGE) * SE;
    const int kc = s % nkc;
    const int c0 = (ct0 + (s / nkc + blockIdx.x) % ntile) * BN;
    stage_tile<T, KC, BN, LD, THREADS>(st, A, (long)kc * KC, K, c0, D, va);
    if (kc == nkc - 1)
      stage_tile<T, BM, BN, LD, THREADS>(st + KC * LD, X, row0, N, c0, D,
                                         vx);
  };

  // the warp's 16 rows of Z*active, columns [kc KC, kc KC + KC), as mma
  // A operands: float32 split into zh/zl; bfloat16 packed pairs in zh.
  // Read from Zs, the block's rows staged in shared memory (zeros beyond
  // N and K), or, when Zs is null, from Z itself.
  uint32_t zh[KS][4], zl[KS][4];
  bool zexact = true;  // every zl of the warp is 0: skip zl*ahi
  auto load_z = [&](int kc, const T* Zs) {
    const int rl = warp * 16 + g;  // row in the block
    auto z_at = [&](int r, int kl) {  // z*active at (rl + r, kc KC + kl)
      const long row = row0 + rl + r;
      const int k = kc * KC + kl;
      if (k >= K) return 0.f;
      const float z = Zs ? to_f(Zs[(rl + r) * LD + kl])
                         : (row < N ? to_f(Z[row * K + k]) : 0.f);
      return z * to_f(act[k]);
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = (q & 1) * 8;
        if constexpr (F32) {
          split(z_at(r, ks * 8 + t + (q >> 1) * 4), zh[ks][q], zl[ks][q]);
        } else {
          const int kl = ks * 16 + 2 * t + (q >> 1) * 8;
          const __nv_bfloat162 p =
              __floats2bfloat162_rn(z_at(r, kl), z_at(r, kl + 1));
          memcpy(&zh[ks][q], &p, sizeof(uint32_t));
        }
      }
    if constexpr (F32) {
      bool e = true;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) e = e && zl[ks][q] == 0u;
      zexact = __all_sync(0xffffffffu, e);
    }
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  if (nkc == 1) {
    // one chunk: stage the block's z rows through the ring's last slot
    // (coalesced copies, free until step 0 refills it) and hold their
    // fragments for every tile
    T* zs = sh + (NSTAGE - 1) * SE;
    stage_tile<T, BM, KC, LD, THREADS>(zs, Z, row0, N, 0, K, vz);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    load_z(0, zs);
    __syncthreads();
  }

  float c[NT][4];
  double tot = 0.0;
  for (int s = 0; s < nsteps; ++s) {
    if (s + NSTAGE - 1 < nsteps) load(s + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const int kc = s % nkc;
    const T* As = sh + (s % NSTAGE) * SE;
    if (nkc > 1) load_z(kc, nullptr);
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[j][q] = 0.f;
    }
    if constexpr (F32) {
      if (zexact)
        tf32_products<false>(c, zh, zl, As, g, t);
      else
        tf32_products<true>(c, zh, zl, As, g, t);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];  // B fragments of n-tiles j and j + 1
          ldmatrix_x4_trans(
              b, As + (ks * 16 + (lane & 15)) * LD + (j + (lane >> 4)) * 8);
          mma_bf16(c[j], zh[ks], b);
          mma_bf16(c[j + 1], zh[ks], b + 2);
        }
    }
    if (kc == nkc - 1) {  // epilogue: the tile's residual squares
      const T* Xs = As + KC * LD;
      float s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T* x = Xs + (warp * 16 + g + h * 8) * LD + j * 8 + 2 * t;
          float2 xv;
          if constexpr (F32)
            xv = *reinterpret_cast<const float2*>(x);
          else
            xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x));
          const float r0 = xv.x - c[j][2 * h], r1 = xv.y - c[j][2 * h + 1];
          s2 = fmaf(r0, r0, s2);
          s2 = fmaf(r1, r1, s2);
        }
      tot += (double)s2;
    }
    __syncthreads();  // the stage may be refilled
  }
  cp_async_wait<0>();
  const double s = block_sum<double, NW>(tot, red);
  if (tid == 0) partial[blockIdx.x] = s;
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

struct Plan {
  int blocks, col_splits, tiles_per_split;
};

// One wave of MIN_BLOCKS blocks per SM: D is split across blocks only
// when the row tiles are fewer than that.
Plan plan(int device, int N, int D) {
  Plan p{0, 1, 1};
  const int rtiles = (N + BM - 1) / BM, ctiles = (D + BN - 1) / BN;
  if (rtiles == 0 || ctiles == 0) return p;
  int cs = (MIN_BLOCKS * sm_count(device)) / rtiles;
  cs = cs < 1 ? 1 : (cs > ctiles ? ctiles : cs);
  p.tiles_per_split = (ctiles + cs - 1) / cs;
  p.col_splits = (ctiles + p.tiles_per_split - 1) / p.tiles_per_split;
  p.blocks = rtiles * p.col_splits;
  return p;
}

// Allow a kernel instance its dynamic shared memory, once per device.
template <typename T, int KC>
cudaError_t allow_smem(int device) {
  static bool done[MAX_DEVICES] = {};
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      sse_mma_kernel<T, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, KC>());
  if (e == cudaSuccess && cached) done[device] = true;
  return e;
}

template <typename T, int KC>
cudaError_t launch_kc(int device, const Plan& p, const T* X, const T* Z,
                      const T* A, const T* act, double* partial, int N,
                      int D, int K, bool vx, bool va, bool vz,
                      cudaStream_t stream) {
  const cudaError_t e = allow_smem<T, KC>(device);
  if (e != cudaSuccess) return e;
  sse_mma_kernel<T, KC><<<p.blocks, THREADS, smem_bytes<T, KC>(), stream>>>(
      X, Z, A, act, partial, N, D, K, p.col_splits, p.tiles_per_split, vx,
      va, vz);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(int device, const void* X_, const void* Z_,
                   const void* A_, const void* act_, double* partial,
                   float* out, int N, int D, int K, cudaStream_t stream) {
  const T *X = (const T*)X_, *Z = (const T*)Z_, *A = (const T*)A_,
          *act = (const T*)act_;
  const Plan p = plan(device, N, D);
  if (p.blocks > 0) {
    // rows of X and A (of Z) start 16-byte aligned: D (K) a multiple of
    // 16 bytes
    constexpr int V = 16 / (int)sizeof(T);
    const bool vx = D % V == 0 && aligned16(X),
               va = D % V == 0 && aligned16(A),
               vz = K % V == 0 && aligned16(Z);
    const cudaError_t e =
        K <= 16   ? launch_kc<T, 16>(device, p, X, Z, A, act, partial, N, D,
                                     K, vx, va, vz, stream)
        : K <= 32 ? launch_kc<T, 32>(device, p, X, Z, A, act, partial, N, D,
                                     K, vx, va, vz, stream)
                  : launch_kc<T, 64>(device, p, X, Z, A, act, partial, N, D,
                                     K, vx, va, vz, stream);
    if (e != cudaSuccess) return e;
  }
  sse_final_kernel<<<1, THREADS, 0, stream>>>(partial, p.blocks, out);
  return cudaGetLastError();
}

}  // namespace

// float64s of partial-sum scratch gaussian_sse_launch needs on `device`
// (the blocks of its first pass).
extern "C" int gaussian_sse_blocks(int device, int N, int D) {
  return plan(device, N, D).blocks;
}

// X (N,D), Z (N,K), A (K,D), act (K), all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1) on CUDA device `device`; partial:
// gaussian_sse_blocks(device, N, D) float64 scratch; out: float32 device
// scalar. Returns the CUDA error of the launches (0 on success).
extern "C" int gaussian_sse_launch(int device, const void* X,
                                   const void* Z, const void* A,
                                   const void* act,
                                   double* partial, float* out, int N, int D,
                                   int K, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = bf16 ? launch<__nv_bfloat16>(device, X, Z, A, act, partial, out, N, D,
                                   K, stream)
           : launch<float>(device, X, Z, A, act, partial, out, N, D, K,
                           stream);
  return (int)e;
}
