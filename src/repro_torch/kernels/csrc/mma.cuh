// Tensor-core helpers shared by the port's kernels: the 3xTF32 split,
// the mma.sync wrappers (TF32 m16n8k8, bf16 m16n8k16, f64 m8n8k4),
// ldmatrix, and the cp.async staging of a tile of a row-major matrix into
// shared memory.
//
// Fragment layouts (PTX ISA, mma.sync m16n8k8 .tf32 and m16n8k16 .bf16),
// with g = lane / 4 and t = lane % 4:
//   TF32 A (16x8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   TF32 B (8x8, col):  b0 (t, g), b1 (t+4, g)
//   bf16 A (16x16):     a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                       a3 (g+8, 2t+8..), the lower column in the low half
//   bf16 B (16x8):      b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C (16x8, f32):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

// The split by truncation: hi keeps the top 19 bits (tf32), lo = x - hi
// is exact in float32, and the tensor cores read lo's top 19 bits, so
// hi + lo is within about 2^-21 |x| of x; a binary z gives hi = z and
// lo = 0. No conversion instruction: on feature_stats' critical path
// cvt.rna.tf32 cost more than the rounding it buys.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, TF32 operands, float32 accumulator (m16n8k8).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b, bfloat16 operands, float32 accumulator (m16n8k16).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b, float64 (m8n8k4, the FP64 tensor cores): thread (g, t) holds
// a (g, t) of A (8x4, row), b (t, g) of B (4x8, col) and c (g, 2t),
// (g, 2t+1) of C.
__device__ __forceinline__ void mma_f64(double* c, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// Four 8x8 b16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned), and
// r[i] is thread (g, t)'s pair (rows 2t, 2t+1; column g) of matrix i, a
// bf16 B fragment when the matrix rows run along k.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One element of a tile that is not copied 16 bytes at a time: a 4-byte
// cp.async for float32, a plain load for bfloat16 (cp.async moves 4, 8 or
// 16 bytes, and such a row need not be 4-byte aligned).
__device__ __forceinline__ void stage_elem(float* d, const float* s) {
  cp_async4(d, s);
}
__device__ __forceinline__ void stage_elem(__nv_bfloat16* d,
                                           const __nv_bfloat16* s) {
  *d = *s;
}

__device__ __forceinline__ void zero_elem(float* d) { *d = 0.f; }
__device__ __forceinline__ void zero_elem(__nv_bfloat16* d) {
  *d = __float2bfloat16(0.f);
}

// Stage rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of src (row-major,
// ld ncols) into dst (ld LD), with the NT threads of the block: 16-byte
// copies where a group of 16 bytes lies inside and ``vec`` says rows are
// 16-byte aligned, else element by element; zeros outside (rows >= rend,
// columns >= ncols).
template <typename T, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long r0,
                                           long rend, int c0, int ncols,
                                           bool vec) {
  constexpr int V = 16 / (int)sizeof(T);  // elements of a 16-byte group
  constexpr int G = COLS / V;             // groups of a row
  static_assert(COLS % V == 0 && LD % V == 0, "16-byte groups");
  for (int i = threadIdx.x; i < ROWS * G; i += NT) {
    const int r = i / G, c = (i % G) * V;
    const long row = r0 + r;
    T* d = dst + r * LD + c;
    const int col = c0 + c;
    if (row < rend && vec && col + V - 1 < ncols) {
      cp_async16(d, src + row * ncols + col);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (row < rend && col + j < ncols)
          stage_elem(d + j, src + row * ncols + col + j);
        else
          zero_elem(d + j);
      }
    }
  }
}

// The device's SM count, read once per device (the launch path is on the
// host's critical path of every call); 132 (an H100 SXM) if unreadable.
inline int sm_count(int device) {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (cache[device] == 0) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cache[device] = sms;
  }
  return cache[device];
}
