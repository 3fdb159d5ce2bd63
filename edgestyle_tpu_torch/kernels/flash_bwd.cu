// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces edgestyle_tpu/ops/flash.py::_dq_kernel and ::_dkv_kernel
// (launched by _flash_backward, the backward of the flash_attention custom
// VJP). With P = exp(S * scale - L), S = q k^T, L the forward's row
// logsumexp and D = rowsum(dO * O) (one torch reduction in the wrapper, as
// the JAX package computes it outside Pallas):
//     dS = P * (dO v^T - D)
//     dq = dS k * scale                 (flash_bwd_dq)
//     dk = dS^T q * scale, dv = P^T dO  (flash_bwd_dkv)
// P is recomputed from (q, k, L); no (N, N) tensor is written.
//
// Design. The TPU runs each pass as a sequential grid that carries its sum
// in VMEM scratch across the inner axis. Here blocks run in parallel in no
// order, so one 4-warp block owns a 64-row tile of the output -- q rows for
// dq, k rows for dk/dv -- and loops over the other axis inside the block,
// 64 rows a step, with the sums in fp32 registers. Each output row is
// written once by one block: no atomics, and the result is deterministic,
// as in the two-pass TPU scheme. The dk/dv pass works on the transposed
// problem (S^T = k q^T, dP^T = v dO^T), so every product has the shape of
// the forward's: a 16-row A fragment per warp against B tiles in shared
// memory, and each result's C fragments are the A fragments of the next
// product (flash_common.cuh). Head dims that are not a multiple of 16
// (D = 40) are zero-padded to 48 in shared memory, as in the forward.
//
// Numerics follow _flash_backward: fp32 S, P and dP; dS rounded to bf16
// (k's and q's type) before the dq and dk products. The Pallas kernel keeps
// P in fp32 for dv (dO was cast to fp32); this kernel rounds P to bf16 for
// the tensor cores, and the card test's tolerance allows for it.
//
// Bound on the H100: dq does 3 products (S, dP, dS k), 6*N*N*D flops per
// head, and dk/dv 4 (S, dP^T, P^T dO, dS^T q), 8*N*N*D, against about
// 10*N*D bytes; at the SD1.5 shapes (N = 4096, D = 40; N = 1024, D = 80)
// the tensor cores bound both. This first version uses mma.sync m16n8k16
// from plain shared-memory tiles, one buffer, no TMA and no wgmma; the
// numbers it reaches are in PERF.md.
//
// Plain C interface (loaded with ctypes): q, k, v, dout and the outputs are
// (BH, N, D) bf16, contiguous; lse and delta are (BH, N) fp32. Each entry
// point returns the cudaError_t of its launch.

#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::c_to_a;
using flash::load_a;
using flash::load_b_cols;
using flash::load_b_rows;
using flash::mma_bf16_16816;

constexpr int kRows = 64;     // rows of a tile: 4 warps x 16
constexpr int kThreads = 128;
constexpr int ST = kRows / 8;  // n-tiles of a 16 x 64 S tile

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)4 * kRows * (DP + 8) * sizeof(__nv_bfloat16) + 2 * kRows * sizeof(float);
}

// dq for one 64-row q tile: loop over the 64-row k/v tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int n, int d, float scale) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;  // k-steps over the head dim
  constexpr int NT = DP / 8;   // n-tiles of the dq accumulator

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kRows * LD;
  __nv_bfloat16* ks = dos + kRows * LD;
  __nv_bfloat16* vs = ks + kRows * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const size_t base = (size_t)bh * n * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int r0 = warp * 16;

  flash::load_tile<DP, kRows, kThreads>(qs, q + base, q0, n, d);
  flash::load_tile<DP, kRows, kThreads>(dos, dout + base, q0, n, d);
  __syncthreads();

  // this warp's 16 q and dO rows stay in registers for the whole loop
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a<DP>(qa[kk], qs, r0, kk, g, tg);
    load_a<DP>(da[kk], dos, r0, kk, g, tg);
  }
  // rows g and g + 8 of the warp: L and D (0 past N, where q and dO rows
  // are 0 too, so dS is 0 there)
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    L[r] = row < n ? lse[(size_t)bh * n + row] : 0.f;
    Dl[r] = row < n ? delta[(size_t)bh * n + row] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kRows) {
    __syncthreads();  // every warp is done with the previous k/v tile
    flash::load_tile<DP, kRows, kThreads>(ks, k + base, k0, n, d);
    flash::load_tile<DP, kRows, kThreads>(vs, v + base, k0, n, d);
    __syncthreads();

    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[2];
        load_b_rows<DP>(b, ks, j, kk, g, tg);
        mma_bf16_16816(s[j], qa[kk], b);
        load_b_rows<DP>(b, vs, j, kk, g, tg);
        mma_bf16_16816(dp[j], da[kk], b);
      }
    }
    // dS = P * (dP - D) in place of S; keys past N get P = 0
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        const float p = key < n ? expf(s[j][e] * scale - L[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - Dl[e >> 1]);
      }
    }
    // dq += dS (16 x 64, bf16) k (64 x DP)
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        load_b_cols<DP>(b, ks, j, kk, g, tg);
        mma_bf16_16816(acc[j], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + r * 8;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + tg * 2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row * d + col) =
            __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
      }
    }
  }
}

// dk and dv for one 64-row k/v tile: loop over the 64-row q/dO tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n,
                     int d, float scale) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int NT = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kRows * LD;
  __nv_bfloat16* qs = vs + kRows * LD;
  __nv_bfloat16* dos = qs + kRows * LD;
  float* ls = reinterpret_cast<float*>(dos + kRows * LD);
  float* dls = ls + kRows;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const size_t base = (size_t)bh * n * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int r0 = warp * 16;

  flash::load_tile<DP, kRows, kThreads>(ks, k + base, k0, n, d);
  flash::load_tile<DP, kRows, kThreads>(vs, v + base, k0, n, d);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kRows) {
    __syncthreads();  // every warp is done with the previous q/dO tile
    flash::load_tile<DP, kRows, kThreads>(qs, q + base, q0, n, d);
    flash::load_tile<DP, kRows, kThreads>(dos, dout + base, q0, n, d);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const bool in = q0 + i < n;
      ls[i] = in ? lse[(size_t)bh * n + q0 + i] : 0.f;
      dls[i] = in ? delta[(size_t)bh * n + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T, 16 keys x 64 queries per warp; the k
    // and v A fragments are re-read from shared memory (fewer registers)
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<DP>(ka, ks, r0, kk, g, tg);
      load_a<DP>(va, vs, r0, kk, g, tg);
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        uint32_t b[2];
        load_b_rows<DP>(b, qs, j, kk, g, tg);
        mma_bf16_16816(s[j], ka, b);
        load_b_rows<DP>(b, dos, j, kk, g, tg);
        mma_bf16_16816(dp[j], va, b);
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T; queries past N get P = 0
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tg * 2 + (e & 1);
        const float p = q0 + c < n ? expf(s[j][e] * scale - ls[c]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dls[c]);
      }
    }
    // dv += P^T dO and dk += dS^T q, (16 x 64, bf16) x (64 x DP)
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, s, kk);
      c_to_a(sa, dp, kk);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        load_b_cols<DP>(b, dos, j, kk, g, tg);
        mma_bf16_16816(dv_acc[j], pa, b);
        load_b_cols<DP>(b, qs, j, kk, g, tg);
        mma_bf16_16816(dk_acc[j], sa, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r0 + g + r * 8;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + tg * 2;
      if (col < d) {
        const size_t off = base + (size_t)row * d + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int n, int d,
                      float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kRows - 1) / kRows, bh);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), n, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int n,
                       int d, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kRows - 1) / kRows, bh);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, d, scale);
  return cudaGetLastError();
}

bool bad_shape(int bh, int n, int d) {
  return d <= 0 || d > 128 || d % 8 != 0 || n <= 0 || bh <= 0;
}

}  // namespace

#define FLASH_BWD_DISPATCH(fn, ...)                                   \
  switch ((d + 15) / 16 * 16) {                                       \
    case 16: return (int)fn<16>(__VA_ARGS__);                         \
    case 32: return (int)fn<32>(__VA_ARGS__);                         \
    case 48: return (int)fn<48>(__VA_ARGS__);                         \
    case 64: return (int)fn<64>(__VA_ARGS__);                         \
    case 80: return (int)fn<80>(__VA_ARGS__);                         \
    case 96: return (int)fn<96>(__VA_ARGS__);                         \
    case 112: return (int)fn<112>(__VA_ARGS__);                       \
    default: return (int)fn<128>(__VA_ARGS__);                        \
  }

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int n, int d,
                            float scale, void* stream) {
  if (bad_shape(bh, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_BWD_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, n, d, scale, s)
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int n, int d, float scale, void* stream) {
  if (bad_shape(bh, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_BWD_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, n, d, scale, s)
}
