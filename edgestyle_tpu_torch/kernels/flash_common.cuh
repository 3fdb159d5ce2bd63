// Helpers of the flash-attention kernels: the bf16 mma.sync m16n8k16
// product, fragment packing and the tile loader of flash_bwd.cu, and the
// fp32 -> bf16 pair packing that flash_fwd.cu also uses.
//
// Fragment layout of mma.sync m16n8k16 for a thread with g = lane / 4 and
// tg = lane % 4:
//   A (16 x 16, row-major)  a0 = (row g,     cols 2tg, 2tg+1)
//                           a1 = (row g + 8, cols 2tg, 2tg+1)
//                           a2 = (row g,     cols 2tg+8, 2tg+9)
//                           a3 = (row g + 8, cols 2tg+8, 2tg+9)
//   B (16 x 8, k-major)     b0 = (k 2tg, 2tg+1; col g), b1 = (k 2tg+8, 2tg+9; col g)
//   C (16 x 8, fp32)        c0, c1 = (row g, cols 2tg, 2tg+1); c2, c3 = row g + 8
// A C tile pair over 16 columns is therefore the A fragment of the next
// product, after packing to bf16 (pack_f32): a product's result never has
// to leave registers to feed the next one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values -> one register of two bf16; `lo` lands in the low half,
// which is the lower-indexed element of an mma fragment pair.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of a (n, d) bf16 matrix into a (ROWS, DP + 8)
// shared tile, 16 bytes per thread per step; zero rows >= n and lanes >= d,
// so padded rows and lanes add nothing to any product.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          int row0, int n, int d) {
  constexpr int LD = DP + 8;
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && c < d) {
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * d + c);
    }
    *reinterpret_cast<uint4*>(s + r * LD + c) = v;
  }
}

// A fragment of rows [r0, r0 + 16), k-step kk, of a (rows, DP + 8) shared tile.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s, int r0,
                                       int kk, int g, int tg) {
  constexpr int LD = DP + 8;
  const __nv_bfloat16* p0 = s + (r0 + g) * LD + kk * 16 + tg * 2;
  const __nv_bfloat16* p1 = p0 + 8 * LD;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment for X * T^T where T is a (rows, DP + 8) shared tile: columns
// n-tile j are rows j*8 .. j*8+7 of T, k-step kk its lanes (contiguous).
template <int DP>
__device__ __forceinline__ void load_b_rows(uint32_t b[2], const __nv_bfloat16* s, int j,
                                            int kk, int g, int tg) {
  constexpr int LD = DP + 8;
  const __nv_bfloat16* p = s + (j * 8 + g) * LD + kk * 16 + tg * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment for X * T where T is a (rows, DP + 8) shared tile: k-step kk
// runs down rows kk*16 .., n-tile j over lanes j*8 .. j*8+7 (strided).
template <int DP>
__device__ __forceinline__ void load_b_cols(uint32_t b[2], const __nv_bfloat16* s, int j,
                                            int kk, int g, int tg) {
  constexpr int LD = DP + 8;
  const __nv_bfloat16* p = s + (kk * 16 + tg * 2) * LD + j * 8 + g;
  b[0] = pack_bf16(p[0], p[LD]);
  b[1] = pack_bf16(p[8 * LD], p[9 * LD]);
}

// The A fragment of k-step kk of a 16 x 64 fp32 C tile set c[8][4], in bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c[][4], int kk) {
  a[0] = pack_f32(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f32(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f32(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f32(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

}  // namespace flash
