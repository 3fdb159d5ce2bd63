// The pieces of the Hopper flash-attention kernels (flash_fwd.cu and both
// kernels of flash_bwd.cu): the fp32 -> bf16 pair packing, the base-2
// exponential, the wgmma shapes they issue, the MN-major operand descriptor
// and the tensor map of a (BH, N, D) bf16 tensor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

// Two fp32 values -> one register of two bf16; `lo` lands in the low half,
// which is the lower-indexed element of an A fragment pair.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kBox = 64;  // columns per TMA box (128-byte rows)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory descriptor of an MN-major bf16 operand in 128-byte swizzle:
// 64-column boxes of 128-byte rows, one row per k, 8-row groups 1024 bytes
// apart (SBO) and boxes `box_bytes` apart (LBO), at a 1024-byte aligned
// address.
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p, uint32_t box_bytes) {
  return (uint64_t)((hopper::smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(box_bytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma's fp32 accumulator operands, eight at a time: C is the constraint
// ("+f" to accumulate, "=f" to overwrite).
#define FLASH_OPS8(C, b)                                                                 \
  C(d[b]), C(d[b + 1]), C(d[b + 2]), C(d[b + 3]), C(d[b + 4]), C(d[b + 5]), C(d[b + 6]), \
      C(d[b + 7])
#define FLASH_ACC8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FLASH_ACC16 FLASH_ACC8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FLASH_ACC24 FLASH_ACC16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define FLASH_ACC32 FLASH_ACC24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define FLASH_ACC40 FLASH_ACC32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define FLASH_ACC48 FLASH_ACC40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define FLASH_ACC56 FLASH_ACC48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define FLASH_ACC64 FLASH_ACC56 ", %56, %57, %58, %59, %60, %61, %62, %63"

// S (64 x N fp32 accumulator: s[4i + 2j + e] is row 16 * warp + lane / 4
// + 8j of the warpgroup, column 8i + 2 * (lane % 4) + e) (+)= A (64 x 16,
// K-major in shared memory) * B (16 x N, K-major in shared memory),
// through their descriptors, for N = 64 and 128. wgmma_ss_first overwrites
// S (its operands are outputs only, so S is dead before it);
// wgmma_ss_acc accumulates.
template <int N>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[N / 2], uint64_t desc_a,
                                               uint64_t desc_b);
template <int N>
__device__ __forceinline__ void wgmma_ss_acc(float (&d)[N / 2], uint64_t desc_a,
                                             uint64_t desc_b);

// NAME, N; ACC: its N / 2 accumulator operands; DA, DB, SC: the operand
// numbers of the two descriptors and the scale-d flag; SCALE_D; then the
// accumulator constraints.
#define FLASH_WGMMA_SS(NAME, N, ACC, DA, DB, SC, SCALE_D, ...)                          \
  template <>                                                                           \
  __device__ __forceinline__ void NAME<N>(float (&d)[N / 2], uint64_t desc_a,           \
                                          uint64_t desc_b) {                            \
    asm volatile("{\n"                                                                  \
                 ".reg .pred p;\n"                                                      \
                 "setp.ne.b32 p, %" #SC ", 0;\n"                                        \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "           \
                 "{" ACC "}, %" #DA ", %" #DB ", p, 1, 1, 0, 0;\n"                      \
                 "}\n"                                                                  \
                 : __VA_ARGS__                                                          \
                 : "l"(desc_a), "l"(desc_b), "r"(SCALE_D));                             \
  }
FLASH_WGMMA_SS(wgmma_ss_first, 64, FLASH_ACC32, 32, 33, 34, 0, FLASH_OPS8("=f", 0),
               FLASH_OPS8("=f", 8), FLASH_OPS8("=f", 16), FLASH_OPS8("=f", 24))
FLASH_WGMMA_SS(wgmma_ss_acc, 64, FLASH_ACC32, 32, 33, 34, 1, FLASH_OPS8("+f", 0),
               FLASH_OPS8("+f", 8), FLASH_OPS8("+f", 16), FLASH_OPS8("+f", 24))
FLASH_WGMMA_SS(wgmma_ss_first, 128, FLASH_ACC64, 64, 65, 66, 0, FLASH_OPS8("=f", 0),
               FLASH_OPS8("=f", 8), FLASH_OPS8("=f", 16), FLASH_OPS8("=f", 24),
               FLASH_OPS8("=f", 32), FLASH_OPS8("=f", 40), FLASH_OPS8("=f", 48),
               FLASH_OPS8("=f", 56))
FLASH_WGMMA_SS(wgmma_ss_acc, 128, FLASH_ACC64, 64, 65, 66, 1, FLASH_OPS8("+f", 0),
               FLASH_OPS8("+f", 8), FLASH_OPS8("+f", 16), FLASH_OPS8("+f", 24),
               FLASH_OPS8("+f", 32), FLASH_OPS8("+f", 40), FLASH_OPS8("+f", 48),
               FLASH_OPS8("+f", 56))

// S = A B^T over KS k-steps of 16 columns, both operands K-major in
// 64-column boxes (A's ABOX bytes apart, B's BBOX): k-step kk reads box
// kk / 4 at 32-byte column offset kk % 4 (the descriptors count 16-byte
// units).
template <int N, int KS, int ABOX, int BBOX>
__device__ __forceinline__ void ss_product(float (&s)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b) {
  wgmma_ss_first<N>(s, desc_a, desc_b);
#pragma unroll
  for (int kk = 1; kk < KS; ++kk) {
    wgmma_ss_acc<N>(s, desc_a + (kk / 4) * (ABOX >> 4) + (kk % 4) * 2,
                    desc_b + (kk / 4) * (BBOX >> 4) + (kk % 4) * 2);
  }
}

// O (64 x N fp32, the same accumulator layout) += A (64 x 16 bf16 from
// registers, each warp's 16 rows as an mma.sync m16n8k16 A fragment) * B
// (16 x N bf16, MN-major in shared memory: the transposed-B form), for
// N = 16, 32, ..., 128: one instruction per N, from the macro below.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t* a,
                                            uint64_t desc_b);

// N: the product's width; ACC: its N / 2 accumulator operands; A0..A3, DS,
// SC: the operand numbers of the A fragment, the B descriptor and the
// scale-d flag that follow them; then the accumulator constraints.
#define FLASH_WGMMA_RS_TB(N, ACC, A0, A1, A2, A3, DS, SC, ...)                          \
  template <>                                                                           \
  __device__ __forceinline__ void wgmma_rs_tb<N>(float (&d)[N / 2], const uint32_t* a,  \
                                                 uint64_t desc_b) {                     \
    asm volatile("{\n"                                                                  \
                 ".reg .pred p;\n"                                                      \
                 "setp.ne.b32 p, %" #SC ", 0;\n"                                        \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "           \
                 "{" ACC "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DS          \
                 ", p, 1, 1, 1;\n"                                                      \
                 "}\n"                                                                  \
                 : __VA_ARGS__                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));    \
  }
#define FLASH_ACC_OPS(b) FLASH_OPS8("+f", b)

FLASH_WGMMA_RS_TB(16, FLASH_ACC8, 8, 9, 10, 11, 12, 13, FLASH_ACC_OPS(0))
FLASH_WGMMA_RS_TB(32, FLASH_ACC16, 16, 17, 18, 19, 20, 21, FLASH_ACC_OPS(0), FLASH_ACC_OPS(8))
FLASH_WGMMA_RS_TB(48, FLASH_ACC24, 24, 25, 26, 27, 28, 29, FLASH_ACC_OPS(0), FLASH_ACC_OPS(8),
                  FLASH_ACC_OPS(16))
FLASH_WGMMA_RS_TB(64, FLASH_ACC32, 32, 33, 34, 35, 36, 37, FLASH_ACC_OPS(0), FLASH_ACC_OPS(8),
                  FLASH_ACC_OPS(16), FLASH_ACC_OPS(24))
FLASH_WGMMA_RS_TB(80, FLASH_ACC40, 40, 41, 42, 43, 44, 45, FLASH_ACC_OPS(0), FLASH_ACC_OPS(8),
                  FLASH_ACC_OPS(16), FLASH_ACC_OPS(24), FLASH_ACC_OPS(32))
FLASH_WGMMA_RS_TB(96, FLASH_ACC48, 48, 49, 50, 51, 52, 53, FLASH_ACC_OPS(0), FLASH_ACC_OPS(8),
                  FLASH_ACC_OPS(16), FLASH_ACC_OPS(24), FLASH_ACC_OPS(32), FLASH_ACC_OPS(40))
FLASH_WGMMA_RS_TB(112, FLASH_ACC56, 56, 57, 58, 59, 60, 61, FLASH_ACC_OPS(0), FLASH_ACC_OPS(8),
                  FLASH_ACC_OPS(16), FLASH_ACC_OPS(24), FLASH_ACC_OPS(32), FLASH_ACC_OPS(40),
                  FLASH_ACC_OPS(48))
FLASH_WGMMA_RS_TB(128, FLASH_ACC64, 64, 65, 66, 67, 68, 69, FLASH_ACC_OPS(0), FLASH_ACC_OPS(8),
                  FLASH_ACC_OPS(16), FLASH_ACC_OPS(24), FLASH_ACC_OPS(32), FLASH_ACC_OPS(40),
                  FLASH_ACC_OPS(48), FLASH_ACC_OPS(56))

// acc += A B over KS k-steps of 16 rows of B (MN-major, rows 128 bytes, so
// k-step kk starts 2048 bytes further), A's fragments 4 registers a k-step.
template <int N, int KS>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2], const uint32_t* a,
                                           uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_rs_tb<N>(acc, a + 4 * kk, desc_b + kk * (2048 >> 4));
}

// The bf16 A fragments of a 64 x 2N fp32 accumulator: the accumulator
// layout, packed in pairs, is wgmma's register A layout.
template <int N>
__device__ __forceinline__ void pack_acc(uint32_t (&p)[N], const float (&s)[2 * N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = pack_f32(s[2 * i], s[2 * i + 1]);
}

// A (BH, N, D) bf16 tensor as a 3-D tensor map (D, N, BH), innermost first;
// a box is 64 columns of `rows` rows of one head, 128-byte swizzle, zeros
// out of bounds (columns past D, rows past N).
inline CUresult encode_rows(hopper::EncodeTiled encode, CUtensorMap* map, const void* ptr,
                            int bh, int n, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {kBox, (cuuint32_t)rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace flash
