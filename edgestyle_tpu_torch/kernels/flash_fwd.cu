// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces edgestyle_tpu/ops/flash.py::_fwd_kernel (launched by
// _flash_forward, exposed as flash_attention). Computes, per batch*head,
//     o   = softmax(q k^T * scale) v
//     lse = rowwise logsumexp(q k^T * scale)
// without writing the (N, N) logits.
//
// Bound on the H100: per logit 4*D tensor-core flops and one exponential.
// The SFU gives 16 exponentials a clock per SM against 2048 bf16 MACs, so
// at D = 40 the exponentials bound the kernel (0.069 ms at BH 16, N 4096)
// and at D = 80 the tensor cores do. What the design does about it:
//   - the softmax is in base 2: one FFMA gives s * (scale * log2 e) - m2,
//     ex2.approx takes the exponential, and per logit nothing else runs but
//     the max, the sum and the bf16 pack; the key mask runs by selects on
//     the first and the last tile only;
//   - the products run on wgmma and the copies on TMA, so the SFU and FP32
//     pipes are left to the softmax, and the softmax of one tile runs while
//     the tensor cores work: within a warpgroup under the previous tile's
//     P V, across the two warpgroups under the other's products.
//
// Design: a block owns 128 query rows (64 when D > 80) and runs one
// producer warp, which issues every copy (TMA), and two consumer
// warpgroups of 64 rows (one when D > 80, whose logits, P and O outgrow the
// 168 registers a thread that ptxas gives a block of more than 256
// threads).
//   - Q, K and V are read by TMA as 3-D tensors (D, N, BH) in 64-column
//     boxes with 128-byte swizzle: the box's columns past D (D = 40:
//     40..63) and its rows past N are zero-filled by TMA, which gives
//     wgmma's canonical K-major layout at any D % 8 == 0. D > 64 takes two
//     boxes.
//   - K and V tiles of 128 keys come through an mbarrier ring of 4 stages
//     (3 when D > 64). Every wait traps after a bounded number of polls
//     (hopper.cuh), so a lost arrival cannot hang the card.
//   - S = Q K^T by wgmma m64n128k16 with both operands in shared memory,
//     over D's own 16-column k-steps (3 at D = 40).
//   - P, packed to bf16 from the S accumulator, is wgmma's register A
//     operand (the accumulator layout, packed, is the A fragment layout);
//     V is the shared-memory B operand, MN-major (the transposed-B form),
//     so O += P V runs at N = D rounded up to 16 (48 at D = 40) and its
//     first 40 columns are stored.
//   - Per tile a warpgroup issues Q K^T of this tile and P V of the last
//     one together, runs this tile's softmax once Q K^T is done (P V still
//     running), and the two warpgroups take turns to issue (named barriers
//     1 and 2), so one's softmax runs under the other's products.
//
// Numerics follow the Pallas kernel: fp32 logits and fp32 row sums, P
// rounded to bf16 (v's type) before the P*V product, the fp32 accumulator
// divided by l at the end. lse is written in natural-log units,
// (m2 + log2 l) * ln 2, as the backward kernels read it. Rows beyond N are
// not stored; keys beyond N get logit -inf. Times are in PERF.md.
//
// Plain C interface (loaded with ctypes): q, k, v, o are (BH, N, D) bf16,
// contiguous, 16-byte aligned; lse is (BH, N) fp32; 8 <= D <= 128,
// D % 8 == 0. Returns the cudaError_t of the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace flash;

constexpr int kBlockK = 128;                 // keys per K/V tile (TMA box rows)
constexpr int kBoxBytes = kBlockK * kBox * 2;  // one K or V box, 16 KB
constexpr float kLn2 = 0.6931471805599453f;

// The block's shape and its shared memory, from a 1024-byte aligned base:
// Q's boxes, the K/V ring (per stage, K's boxes then V's), the mbarriers.
template <int DP>
struct Layout {
  // Consumer warpgroups of 64 query rows: two up to D = 80, where the 168
  // registers a thread that ptxas gives a block of more than 256 threads
  // hold a warpgroup's logits, P and O; one above, where they need more.
  static constexpr int kWG = DP <= 80 ? 2 : 1;
  static constexpr int kBlockQ = 64 * kWG;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  static constexpr int kBoxes = DP > 64 ? 2 : 1;
  static constexpr int kStages = kBoxes == 1 ? 4 : 3;
  static constexpr int kQBoxBytes = kBlockQ * kBox * 2;
  static constexpr int kKV = kBoxes * kQBoxBytes;
  static constexpr int kStageBytes = 2 * kBoxes * kBoxBytes;
  static constexpr int kBar = kKV + kStages * kStageBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};


// s = Q K^T over KS k-steps of 16 columns (Q's boxes QBOX bytes apart,
// K's kBoxBytes).
template <int KS, int QBOX>
__device__ __forceinline__ void qk(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
  ss_product<kBlockK, KS, QBOX, kBoxBytes>(s, desc_q, desc_k);
}

// acc += P V over the tile's 8 k-steps of 16 keys.
template <int DP>
__device__ __forceinline__ void pv(float (&acc)[DP / 2], const uint32_t (&p)[32],
                                   uint64_t desc_v) {
  rs_product<DP, kBlockK / 16>(acc, p, desc_v);
}

// The online softmax of one tile's logits s, in place: s becomes the fp32
// probabilities exp2(s * c - m2) against the new running max m2 (base-2
// exponent units), l the rescaled running row sum, alpha the factor that
// rescales the accumulator. With kMask, keys >= `valid` get -inf, by
// selects (no branch near the products). Each row's max and sum run as
// four independent chains.
template <bool kMask>
__device__ __forceinline__ void softmax(float (&s)[64], float (&m2)[2], float (&l)[2],
                                        float (&alpha)[2], float c, int valid, int tg) {
  if constexpr (kMask) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = (i / 4) * 8 + tg * 2 + (i & 1) < valid ? s[i] : -INFINITY;
    }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[r][j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
    for (int i = 4; i < 16; ++i) {
      mx[r][i & 3] = fmaxf(mx[r][i & 3], fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    }
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float mnew = fmaxf(m2[r], m * c);
    alpha[r] = ex2(m2[r] - mnew);  // 0 on the first tile (m2 = -inf)
    m2[r] = mnew;
    neg[r] = -mnew;
  }
  float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], c, neg[r]));
    rs[r][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// With two warpgroups, named barriers 1 and 2 order their product issues:
// warpgroup wg waits at 1 + wg for its turn and ends it by arriving at the
// other's, so their products alternate on the tensor cores and one's
// softmax runs under the other's products. A turn ends once the
// warpgroup's Q K^T is done, and the barrier numbers and counts are
// selected, not branched on: an arrival right after the issue, or a
// barrier on a divergent path, made ptxas serialise the wgmma.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
template <int WG>
__device__ __forceinline__ void turn_begin(int wg) {
  if constexpr (WG == 2) bar_sync(1 + wg, 256);
}
template <int WG>
__device__ __forceinline__ void turn_end(int wg) {
  if constexpr (WG == 2) bar_arrive(2 - wg, 256);
}

// DP: the head dim rounded up to 16, the k extent of Q K^T and the width
// of P V.
template <int DP>
__global__ void __launch_bounds__(Layout<DP>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int n, int d, float c) {
  using L = Layout<DP>;
  constexpr int S = L::kStages;
  constexpr int KS = DP / 16;  // k-steps of Q K^T
  constexpr int WG = L::kWG;
  constexpr int kConsumers = L::kConsumers;
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* kv = smem + L::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * L::kBlockQ;
  const int ntiles = (n + kBlockK - 1) / kBlockK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer warp: one thread loads Q once, then tile t's K and V into
    // stage t % S once every consumer thread has released what the stage
    // held before.
    if (lane != 0) return;
    mbar_expect_tx(q_full, L::kBoxes * L::kQBoxBytes);
    for (int b = 0; b < L::kBoxes; ++b) {
      tma_load_3d(qs + b * L::kQBoxBytes, &tm_q, q_full, b * kBox, q0, bh);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int stage = t % S;
      unsigned char* st = kv + stage * L::kStageBytes;
      mbar_wait(&empty[stage], ((t / S) & 1) ^ 1);
      mbar_expect_tx(&full[stage], L::kStageBytes);
      for (int b = 0; b < L::kBoxes; ++b) {
        tma_load_3d(st + b * kBoxBytes, &tm_k, &full[stage], b * kBox, t * kBlockK, bh);
        tma_load_3d(st + (L::kBoxes + b) * kBoxBytes, &tm_v, &full[stage], b * kBox,
                    t * kBlockK, bh);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows 64wg..64wg+63 of the tile; this
  // thread rows g and g + 8 of its warp's 16.
  const int wg = warp / 4;
  const int tg = lane & 3;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + (lane >> 2);

  float s[64];          // logits, then probabilities, of one 128-key tile
  float acc[DP / 2];    // O, unnormalised
  uint32_t p[32];       // P in bf16: 8 k-steps of A fragments
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};  // running row max, base-2 exponent units
  float l[2] = {0.f, 0.f};               // per-thread partial row sums
  float alpha[2];
  const uint64_t dq = desc_sw128(qs + wg * 64 * 128);
  auto desc_k = [&](int t) { return desc_sw128(kv + (t % S) * L::kStageBytes); };
  auto desc_v = [&](int t) {
    return desc_sw128_mn(kv + (t % S) * L::kStageBytes + L::kBoxes * kBoxBytes, kBoxBytes);
  };

  // Turns: each warpgroup takes one per product issue, ntiles + 1 in all;
  // the second warpgroup's first arrival lets the first warpgroup start,
  // and the first warpgroup's last wait takes the second's last arrival
  // (the other warpgroup meets a barrier of its own, 3 or 4, alone).
  mbar_wait(q_full, 0);
  if constexpr (WG == 2) bar_arrive(wg == 1 ? 1 : 3, wg == 1 ? 256 : 128);
  mbar_wait(&full[0], 0);
  turn_begin<WG>(wg);
  wgmma_fence();
  qk<KS, L::kQBoxBytes>(s, dq, desc_k(0));
  wgmma_commit();
  wgmma_wait<0>();
  turn_end<WG>(wg);
  fence_acc(s);
  softmax<true>(s, m2, l, alpha, c, n, tg);
  pack_acc(p, s);

  // Tile t >= 1; the last one masked (its keys past N).
  auto step = [&](int t, auto masked) {
    mbar_wait(&full[t % S], (t / S) & 1);
    rescale(acc, alpha);
    turn_begin<WG>(wg);
    wgmma_fence();
    // Q K^T of tile t and P V of tile t - 1 together; the softmax of tile
    // t runs while P V still does.
    qk<KS, L::kQBoxBytes>(s, dq, desc_k(t));
    wgmma_commit();
    pv<DP>(acc, p, desc_v(t - 1));
    wgmma_commit();
    wgmma_wait<1>();
    turn_end<WG>(wg);
    fence_acc(s);
    softmax<decltype(masked)::value>(s, m2, l, alpha, c, n - t * kBlockK, tg);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(p);
    mbar_arrive(&empty[(t - 1) % S]);
    pack_acc(p, s);
  };
  for (int t = 1; t + 1 < ntiles; ++t) step(t, std::false_type());
  if (ntiles > 1) step(ntiles - 1, std::true_type());

  rescale(acc, alpha);
  turn_begin<WG>(wg);
  wgmma_fence();
  pv<DP>(acc, p, desc_v(ntiles - 1));
  wgmma_commit();
  wgmma_wait<0>();
  turn_end<WG>(wg);
  fence_acc(acc);
  if constexpr (WG == 2) bar_sync(wg == 0 ? 1 : 4, wg == 0 ? 256 : 128);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t base = (size_t)bh * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = o + (base + row) * d;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + tg * 2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      }
    }
    if (tg == 0) lse[base + row] = (m2[r] + log2f(l[r])) * kLn2;
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int n, int d, float scale, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (encode_rows(encode, &tm_q, q, bh, n, d, Layout<DP>::kBlockQ) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_k, k, bh, n, d, kBlockK) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_v, v, bh, n, d, kBlockK) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + Layout<DP>::kBlockQ - 1) / Layout<DP>::kBlockQ, bh);
  flash_fwd_kernel<DP><<<grid, Layout<DP>::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), n, d,
      scale * kLog2e);
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
