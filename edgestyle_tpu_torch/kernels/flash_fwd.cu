// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces edgestyle_tpu/ops/flash.py::_fwd_kernel (launched by
// _flash_forward, exposed as flash_attention). Computes, per batch*head,
//     o   = softmax(q k^T * scale) v
//     lse = rowwise logsumexp(q k^T * scale)
// without writing the (N, N) logits: each block owns one 64-row query tile
// and streams 64-row K/V tiles through shared memory, carrying the online
// softmax state (row max m, row sum l) and an fp32 accumulator in registers.
//
// Bound on the H100: at the SD1.5 shapes (N = 4096, D = 40 and N = 1024,
// D = 80) the work is 4*N*N*D flops per head against 8*N*D bytes, so the
// tensor cores bound it, not memory. This first version uses mma.sync
// m16n8k16 (bf16 -> fp32) from plain shared-memory tiles, one buffer, no
// TMA and no wgmma; the numbers it reaches are in PERF.md.
//
// Numerics follow the Pallas kernel: the scale multiplies the fp32 logits,
// the row sum uses the fp32 probabilities, and P is rounded to bf16 (v's
// type) before the P*V product. Head dims that are not a multiple of 16
// (D = 40) are zero-padded in shared memory to the next multiple of 16, so
// the padded lanes add nothing to q k^T and produce columns that are never
// stored. Rows beyond N are not stored; keys beyond N get logit -inf.
//
// Plain C interface (loaded with ctypes): q, k, v, o are (BH, N, D) bf16,
// contiguous; lse is (BH, N) fp32. Returns the cudaError_t of the launch.

#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::c_to_a;
using flash::load_a;
using flash::load_b_cols;
using flash::load_b_rows;
using flash::mma_bf16_16816;

constexpr int kBlockQ = 64;   // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kThreads = 128;

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int n, int d, float scale) {
  constexpr int LD = DP + 8;     // padded row stride of the shared tiles
  constexpr int KS = DP / 16;    // k-steps of q k^T
  constexpr int NT = DP / 8;     // n-tiles of the output accumulator
  constexpr int ST = kBlockK / 8;  // n-tiles of the logits

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * LD;
  __nv_bfloat16* vs = ks + kBlockK * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * n * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // mma group: rows g and g + 8
  const int tg = lane & 3;   // thread in group: column pair 2*tg
  const int r0 = warp * 16;

  flash::load_tile<DP, kBlockQ, kThreads>(qs, q + base, q0, n, d);
  __syncthreads();

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a<DP>(qa[kk], qs, r0, kk, g, tg);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    flash::load_tile<DP, kBlockK, kThreads>(ks, k + base, k0, n, d);
    flash::load_tile<DP, kBlockK, kThreads>(vs, v + base, k0, n, d);
    __syncthreads();

    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[2];
        load_b_rows<DP>(b, ks, j, kk, g, tg);
        mma_bf16_16816(s[j], qa[kk], b);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        const float val = key < n ? s[j][e] * scale : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
    }

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // P (16 x 64, bf16) * V (64 x DP): the logits' accumulator layout is
    // the A-fragment layout, so P never leaves registers.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s, kk);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        load_b_cols<DP>(b, vs, j, kk, g, tg);
        mma_bf16_16816(acc[j], pa, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + r * 8;
    if (row >= n) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + tg * 2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row * d + col) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      }
    }
    if (tg == 0) lse[(size_t)bh * n + row] = m[r] + logf(l[r]);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int bh, int n, int d, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kBlockQ + 2 * kBlockK) * (DP + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), n, d, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int n, int d, float scale, void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || n <= 0 || bh <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return (int)launch<16>(q, k, v, o, lse, bh, n, d, scale, s);
    case 32: return (int)launch<32>(q, k, v, o, lse, bh, n, d, scale, s);
    case 48: return (int)launch<48>(q, k, v, o, lse, bh, n, d, scale, s);
    case 64: return (int)launch<64>(q, k, v, o, lse, bh, n, d, scale, s);
    case 80: return (int)launch<80>(q, k, v, o, lse, bh, n, d, scale, s);
    case 96: return (int)launch<96>(q, k, v, o, lse, bh, n, d, scale, s);
    case 112: return (int)launch<112>(q, k, v, o, lse, bh, n, d, scale, s);
    default: return (int)launch<128>(q, k, v, o, lse, bh, n, d, scale, s);
  }
}
