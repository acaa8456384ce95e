// feature_stats: the master sync's sufficient statistics in one pass,
// Z^T Z (K,K), Z^T X (K,D) and m = column sums of Z (K).
//
// Replaces feature_stats_pallas (src/repro/kernels/feature_stats/kernel.py:36,
// body :21), which walks row blocks in order and accumulates all three
// products into one resident output block.
//
// What bounds it on the H100: bytes. At N=32768, K=64, D=1024 the inputs
// are 136 MiB (X and Z read once: about 43 us at 3.35 TB/s). The products
// are 2 N K (D + K) = 4.6 GFLOP, but for a binary Z (the sampler's) the
// work the data needs is one add per nonzero z per column, under 1 GFLOP
// (about 12 us at 67 TFLOP/s): chip_smoke.py's bound counts those adds
// and finds bytes. Done as float32 multiply-adds on the CUDA cores the
// products would take at least 69 us, so this kernel runs them on the
// tensor cores.
//
// Design:
//   * The output is tiled into 64 features x 64 columns of the virtual
//     matrix Y = [X | Z] (Z^T Z is the Z columns), and the rows are split
//     into chunks, one block per (tile, chunk): enough blocks to fill the
//     132 SMs. Each block writes a float32 partial into a workspace the
//     wrapper allocates; a second kernel sums the partials in a fixed
//     order in float64. No float atomics: every call is bitwise equal.
//   * Z and Y rows stream through a ring of 2 shared-memory stages of 96
//     rows with cp.async, so the next stage loads while one is used.
//   * Products run on the tensor cores as 3xTF32 (mma.sync m16n8k8): each
//     operand is split as hi = tf32(a), lo = tf32(a - hi) (by truncation,
//     see split), and lo*hi + hi*lo + hi*hi is accumulated in float32,
//     which keeps float32 accuracy to about 2^-21 (this is not TF32
//     rounding). For a binary Z, hi = z and lo = 0, so every product with
//     z is exact and Z^T Z stays exact.
//   * The tensor cores' float32 accumulator restarts every stage (96
//     rows); stage sums are added into float64 registers, so long row
//     chunks do not accumulate float32 rounding (the tensor cores' own
//     float32 accumulation over a whole chunk misses atol 1e-4 on Z^T X
//     at N=32768).
//   * m comes from the block of each chunk that holds the first Z tile:
//     it sums the staged Z rows in float64, exact for a binary Z.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

// A block: 2 x 4 warps, each a 32-feature x 16-column warp tile; two
// blocks fit an SM (registers and shared memory).
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;
constexpr int BM = 64;          // features of a tile
constexpr int BN = 64;          // columns of a tile
constexpr int BK = 96;          // rows of a stage
constexpr int NSTAGE = 2;
constexpr int LDS = BM + 8;     // padded smem row: conflict-free fragments
static_assert(BN == BM, "one padded row length for both operands");
constexpr int STAGE_FLOATS = 2 * BK * LDS;  // Z rows, then Y rows
constexpr int SMEM_BYTES = NSTAGE * STAGE_FLOATS * (int)sizeof(float);

// grid (tiles, chunks). Tile t: feature tile t / nyt, column tile t % nyt
// of Y = [X | Z] (the first ceil(D/BN) are X tiles). ws[(chunk K + k)
// (D + K + 1) + col]: the chunk's partial of column col (D + K: m).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
feature_stats_partial_kernel(const float* __restrict__ X,
                             const float* __restrict__ Z,
                             float* __restrict__ ws, int N, int D, int K,
                             int rows_per_chunk, bool vx, bool vz) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int nxt = (D + BN - 1) / BN;
  const int nyt = nxt + (K + BN - 1) / BN;
  const int mt = blockIdx.x / nyt, yt = blockIdx.x % nyt;
  const bool ytile_x = yt < nxt;
  const int m0 = mt * BM;
  const int y0 = ytile_x ? yt * BN : (yt - nxt) * BN;  // column in X or Z
  const float* Ysrc = ytile_x ? X : Z;
  const int ycols = ytile_x ? D : K;
  const bool vy = ytile_x ? vx : vz;
  const bool do_m = !ytile_x && y0 == 0;
  const long r_begin = (long)blockIdx.y * rows_per_chunk;
  const long r_end =
      r_begin + rows_per_chunk < N ? r_begin + rows_per_chunk : (long)N;
  const int nst = (int)((r_end - r_begin + BK - 1) / BK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 32 x 16

  double acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
  double msum = 0.0;

  auto load = [&](int s) {
    float* st = sh + (s % NSTAGE) * STAGE_FLOATS;
    const long r0 = r_begin + (long)s * BK;
    stage_tile<float, BK, BM, LDS, THREADS>(st, Z, r0, r_end, m0, K, vz);
    stage_tile<float, BK, BN, LDS, THREADS>(st + BK * LDS, Ysrc, r0, r_end,
                                            y0, ycols, vy);
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    if (s + NSTAGE - 1 < nst) load(s + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const float* Zs = sh + (s % NSTAGE) * STAGE_FLOATS;
    const float* Ys = Zs + BK * LDS;
    float c[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = Zs + (kk + t) * LDS + wm * 32 + i * 16 + g;
        split(a[0], ah[i][0], al[i][0]);
        split(a[8], ah[i][1], al[i][1]);
        split(a[4 * LDS], ah[i][2], al[i][2]);
        split(a[4 * LDS + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* b = Ys + (kk + t) * LDS + wn * 16 + j * 8 + g;
        split(b[0], bh[j][0], bl[j][0]);
        split(b[4 * LDS], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_tf32(c[i][j], al[i], bh[j]);
          mma_tf32(c[i][j], ah[i], bl[j]);
          mma_tf32(c[i][j], ah[i], bh[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += (double)c[i][j][q];
    if (do_m && tid < BM) {
      float s32 = 0.f;  // the staged rows of one feature
#pragma unroll 8
      for (int r = 0; r < BK; ++r) s32 += Zs[r * LDS + tid];
      msum += (double)s32;
    }
    __syncthreads();  // the stage may be refilled
  }
  cp_async_wait<0>();

  const long ldw = (long)D + K + 1;
  float* wsb = ws + (long)blockIdx.y * K * ldw;
  const int col0 = ytile_x ? y0 : D + y0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = m0 + wm * 32 + i * 16 + g + (q >> 1) * 8;
        const int cy = y0 + wn * 16 + j * 8 + 2 * t + (q & 1);
        if (k < K && cy < ycols)
          wsb[(long)k * ldw + col0 - y0 + cy] = (float)acc[i][j][q];
      }
  if (do_m && tid < BM && m0 + tid < K)
    wsb[(long)(m0 + tid) * ldw + D + K] = (float)msum;
}

// out = sum over chunks of the partials, in chunk order, in float64.
__global__ void feature_stats_sum_kernel(const float* __restrict__ ws,
                                         float* __restrict__ ztz,
                                         float* __restrict__ ztx,
                                         float* __restrict__ m, int D, int K,
                                         int chunks) {
  const long ldw = (long)D + K + 1;
  const long per = (long)K * ldw;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < per;
       e += (long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int c = 0; c < chunks; ++c) s += (double)ws[c * per + e];
    const int k = (int)(e / ldw), col = (int)(e % ldw);
    if (col < D)
      ztx[(long)k * D + col] = (float)s;
    else if (col < D + K)
      ztz[(long)k * K + col - D] = (float)s;
    else
      m[k] = (float)s;
  }
}

struct Plan {
  int tiles, chunks, rows_per_chunk;
};

constexpr int MAX_DEVICES = 64;

Plan plan(int device, int N, int D, int K) {
  Plan p;
  const int nyt = (D + BN - 1) / BN + (K + BN - 1) / BN;
  p.tiles = ((K + BM - 1) / BM) * nyt;
  // MIN_BLOCKS blocks per SM in one wave, each chunk whole stages
  const int stages = (N + BK - 1) / BK;
  int chunks = (MIN_BLOCKS * sm_count(device)) / p.tiles;
  chunks = chunks < 1 ? 1 : (chunks > stages ? stages : chunks);
  const int st_per = (stages + chunks - 1) / chunks;
  p.rows_per_chunk = st_per * BK;
  p.chunks = stages == 0 ? 1 : (stages + st_per - 1) / st_per;
  return p;
}

// Allow the partial kernel its dynamic shared memory, once per device.
cudaError_t allow_smem(int device) {
  static bool done[MAX_DEVICES] = {};
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      feature_stats_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess && cached) done[device] = true;
  return e;
}

}  // namespace

// Floats of workspace feature_stats_launch needs on `device`.
extern "C" long feature_stats_workspace_floats(int device, int N, int D,
                                               int K) {
  const Plan p = plan(device, N, D, K);
  return (long)p.chunks * K * ((long)D + K + 1);
}

// X (N,D), Z (N,K) float32 on CUDA device `device`; outputs ztz (K,K),
// ztx (K,D), m (K); ws: feature_stats_workspace_floats(device, N, D, K)
// floats. Returns the CUDA error of the launches (0 on success).
extern "C" int feature_stats_launch(int device, const float* X,
                                    const float* Z, float* ztz, float* ztx,
                                    float* m, float* ws, int N, int D, int K,
                                    void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (K <= 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan(device, N, D, K);
  e = allow_smem(device);
  if (e != cudaSuccess) return (int)e;
  const bool vx = D % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  const bool vz = K % 4 == 0 && (reinterpret_cast<uintptr_t>(Z) & 15) == 0;
  feature_stats_partial_kernel<<<dim3(p.tiles, p.chunks), THREADS,
                                 SMEM_BYTES, stream>>>(
      X, Z, ws, N, D, K, p.rows_per_chunk, vx, vz);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long outs = (long)K * ((long)D + K + 1);
  const int blocks = (int)((outs + 255) / 256 < 1024 ? (outs + 255) / 256
                                                     : 1024);
  feature_stats_sum_kernel<<<blocks, 256, 0, stream>>>(ws, ztz, ztx, m, D, K,
                                                       p.chunks);
  return (int)cudaGetLastError();
}
