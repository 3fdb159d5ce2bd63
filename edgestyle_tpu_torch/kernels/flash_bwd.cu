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
// P is recomputed from (q, k, L); no (N, N) tensor is written. The TPU
// runs each pass as a sequential grid that carries its sum in VMEM scratch
// across the inner axis. Here blocks run in parallel in no order, so a
// block owns rows of one output -- q rows for dq, k rows for dk/dv -- and
// loops over the other axis inside the block with the sums in fp32
// registers. Each output row is written once by one block: no atomics, and
// the result is deterministic, as in the two-pass TPU scheme.
//
// Numerics follow _flash_backward: fp32 S, P and dP; dS rounded to bf16
// (k's and q's type) before the dq and dk products. The Pallas kernel keeps
// P in fp32 for dv (dO was cast to fp32); these kernels round P to bf16 for
// the tensor cores, and the card test's tolerance allows for it.
//
// Bound on the H100: dq does 3 products (S, dP, dS k), 6*N*N*D flops per
// head, and dk/dv 4 (S, dP^T, P^T dO, dS^T q), 8*N*N*D, against about
// 10*N*D bytes, and both take N*N exponentials per head. At the SD1.5
// shapes (N = 4096, D = 40; N = 1024, D = 80) the tensor cores bound
// dk/dv; at D = 40 the special-function unit's exponentials bound dq.
//
// flash_bwd_dq, for Hopper: the forward's problem with L known and one
// product more, on the same primitives (flash_common.cuh, hopper.cuh).
//   - A block owns 128 query rows (64 when D > 80, where dQ, one step's S
//     and dP and the packed dS of the step before outgrow the 168 registers
//     a thread that ptxas gives a block of more than 256 threads) and runs
//     one producer warp and one consumer warpgroup per 64 queries. Q and dO
//     are read once by TMA and stay in shared memory; each thread keeps its
//     two rows' L * log2 e and D in registers.
//   - The producer streams the keys in steps of 64 through an mbarrier ring
//     (up to 8 stages, as many as fit beside Q and dO): per step K's and V's
//     (D, N, BH) boxes of 64 columns in 128-byte swizzle, zero-filled by TMA
//     past D and past N (so D = 40 needs no padding copy). Every wait traps
//     after a bounded number of polls.
//   - S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands
//     K-major in shared memory, as the forward's Q K^T.
//   - P = ex2(S * (scale * log2 e) - L * log2 e), one FFMA and one ex2 per
//     logit, and dS = P * (dP - D) are computed in the accumulator
//     registers; keys past N are masked on the last step only. dS is packed
//     to bf16 as the register A operand, as the forward packs P.
//   - dQ += dS K takes K as the MN-major (transposed-B) operand from the box
//     that served S, as the forward takes V, at N = D rounded up to 16. dQ
//     is scaled once at the end.
//   - Per step a warpgroup issues S and dP of step t + 1, then dQ of step
//     t, and computes P and dS of step t + 1 while dQ of step t runs; the
//     two warpgroups' products interleave on the tensor cores. The last dQ
//     is peeled, so no product is issued on a conditional path. In one call
//     this ran 4-8% faster than dk/dv's staggered schedule (dQ of step t
//     with S of step t + 1, then dP of step t + 1 under the exponentials),
//     and turns between the two warpgroups (the forward's named barriers)
//     made it 0.5-5% slower (PERF.md).
//
// flash_bwd_dkv, for Hopper: the forward's problem transposed, on the
// forward's primitives (flash_common.cuh, hopper.cuh).
//   - A block owns 128 key rows (64 when D > 48, whose accumulators outgrow
//     the 168 registers a thread that ptxas gives a block of more than 256
//     threads) and runs one producer warp and one consumer warpgroup per 64
//     keys. K and V are read once by TMA and stay in shared memory.
//   - The producer streams the queries in steps of 64 through an mbarrier
//     ring (4 stages, 3 when D > 64): per step Q's and dO's (D, N, BH) boxes
//     of 64 columns in 128-byte swizzle, zero-filled by TMA past D and past
//     N (so D = 40 needs no padding copy), and the step's 64 values of L and
//     of D by 1-D TMA. Every wait traps after a bounded number of polls.
//   - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
//     K-major in shared memory, as the forward's Q K^T.
//   - P^T = ex2(S^T * (scale * log2 e) - L * log2 e), one FFMA and one ex2
//     per logit, and dS^T = P^T * (dP^T - D) are computed in the
//     accumulator registers (L and D read from the stage per accumulator
//     column); queries past N are masked on the last step only. Both are
//     packed to bf16 as the register A operand, as the forward packs P.
//   - dV += P^T dO and dK += dS^T Q take dO and Q as the MN-major
//     (transposed-B) operand, as the forward takes V, at N = D rounded up
//     to 16. dK is scaled once at the end.
//   - Per step a warpgroup issues dV, dK of step t with S^T of step t + 1,
//     then dP^T of step t + 1, under which it computes P^T of step t + 1;
//     the two warpgroups' products interleave on the tensor cores. Issuing
//     all four products of two steps together (S^T, dP^T in flight beside
//     the packed P^T, dS^T) spilled at D = 40 and ran 20% slower; one step
//     after the other ran 2-4% slower at D = 40 and 9-10% slower at D = 80,
//     timed against this schedule in one process (PERF.md).
//
// Plain C interface (loaded with ctypes): q, k, v, dout and the outputs are
// (BH, N, D) bf16, contiguous, 16-byte aligned; lse and delta are (BH, N)
// fp32, 16-byte aligned; 8 <= D <= 128, D % 8 == 0. Each entry point
// returns the cudaError_t of its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace flash;

constexpr int kStepK = 64;  // keys per dq step (rows of a K or V box)

// The dq block's shape and its shared memory, from a 1024-byte aligned
// base: Q's boxes, dO's boxes, the ring (per stage: K's boxes, V's boxes),
// the mbarriers.
template <int DP>
struct DqLayout {
  // Consumer warpgroups of 64 query rows: two up to D = 80, where dQ, one
  // step's S and dP and the packed dS of the step before fit the 168
  // registers a thread that ptxas gives a block of more than 256 threads
  // (164 at D = 80); one above (two spilled at D = 96).
  static constexpr int kWG = DP <= 80 ? 2 : 1;
  static constexpr int kBlockQ = 64 * kWG;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  static constexpr int kBoxes = DP > 64 ? 2 : 1;
  static constexpr int kQBox = kBlockQ * 128;  // one Q or dO box
  static constexpr int kKBox = kStepK * 128;   // one K or V box, 8 KB
  static constexpr int kQD = 2 * kBoxes * kQBox;
  static constexpr int kStageBytes = 2 * kBoxes * kKBox;
  // as many stages as fit in 200 KB beside Q and dO, at most 8 (512 keys
  // ahead, as the forward's 4 stages of 128)
  static constexpr int kFit = (200 * 1024 - kQD) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBar = kQD + kStages * kStageBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// P of one step in place of S. In the accumulator layout s[4i + 2j + e] is
// row g + 8j of the thread's warp (g = lane / 4) and key 8i + 2 tg + e of
// the step; nl[j] is that row's -L * log2 e. p = ex2(s * c + nl) with c =
// scale * log2 e. With kMask, keys >= `valid` get p = 0 (and so ds = 0), by
// selects.
template <bool kMask>
__device__ __forceinline__ void row_probs(float (&s)[32], const float (&nl)[2], float c,
                                          int valid, int tg) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(s[i], c, nl[(i >> 1) & 1]));
    s[i] = kMask && (i / 4) * 8 + 2 * tg + (i & 1) >= valid ? 0.f : p;
  }
}

// dS = P * (dP - D) in place of dP, from P in p; dl[j] is row j's D.
__device__ __forceinline__ void row_dscores(float (&dp)[32], const float (&p)[32],
                                            const float (&dl)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - dl[(i >> 1) & 1]);
}

// DP: the head dim rounded up to 16, the k extent of S and dP and the width
// of dQ.
template <int DP>
__global__ void __launch_bounds__(DqLayout<DP>::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int n,
                    int d, float c, float scale) {
  using L = DqLayout<DP>;
  constexpr int S = L::kStages;
  constexpr int KS = DP / 16;  // k-steps of S and dP
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* dos = smem + L::kBoxes * L::kQBox;
  unsigned char* ring = smem + L::kQD;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * L::kBlockQ;
  const int nsteps = (n + kStepK - 1) / kStepK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == L::kConsumers / 32) {
    // Producer warp: one thread loads Q and dO once, then step t's K and V
    // into stage t % S once every consumer thread has released what the
    // stage held before.
    if (lane != 0) return;
    mbar_expect_tx(qd_full, L::kQD);
    for (int b = 0; b < L::kBoxes; ++b) {
      tma_load_3d(qs + b * L::kQBox, &tm_q, qd_full, b * kBox, q0, bh);
      tma_load_3d(dos + b * L::kQBox, &tm_do, qd_full, b * kBox, q0, bh);
    }
    for (int t = 0; t < nsteps; ++t) {
      const int stage = t % S;
      unsigned char* st = ring + stage * L::kStageBytes;
      mbar_wait(&empty[stage], ((t / S) & 1) ^ 1);
      mbar_expect_tx(&full[stage], L::kStageBytes);
      for (int b = 0; b < L::kBoxes; ++b) {
        tma_load_3d(st + b * L::kKBox, &tm_k, &full[stage], b * kBox, t * kStepK, bh);
        tma_load_3d(st + (L::kBoxes + b) * L::kKBox, &tm_v, &full[stage], b * kBox,
                    t * kStepK, bh);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows 64wg..64wg+63 of the block; this
  // thread rows g and g + 8 of its warp's 16, whose -L * log2 e and D it
  // keeps (0 past N, where Q's and dO's rows are 0 too, so dS is 0 there).
  const int wg = warp / 4;
  const int tg = lane & 3;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + (lane >> 2);
  const size_t base = (size_t)bh * n;
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    nl[r] = row < n ? -lse[base + row] * kLog2e : 0.f;
    dl[r] = row < n ? delta[base + row] : 0.f;
  }

  float s[32];       // S, then P, of one step: 64 queries x 64 keys
  float dp[32];      // dP, then dS
  float acc[DP / 2];  // dQ, unscaled
  uint32_t dsa[16];  // dS in bf16: 4 k-steps of A fragments
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint64_t desc_q = desc_sw128(qs + wg * 64 * 128);
  const uint64_t desc_do = desc_sw128(dos + wg * 64 * 128);
  auto stage_of = [&](int t) { return ring + (t % S) * L::kStageBytes; };
  // S = Q K^T, dP = dO V^T, and dQ += dS K (K MN-major), of step t
  auto scores = [&](int t) {
    ss_product<kStepK, KS, L::kQBox, L::kKBox>(s, desc_q, desc_sw128(stage_of(t)));
  };
  auto dprobs = [&](int t) {
    ss_product<kStepK, KS, L::kQBox, L::kKBox>(
        dp, desc_do, desc_sw128(stage_of(t) + L::kBoxes * L::kKBox));
  };
  auto grads = [&](int t) {
    rs_product<DP, kStepK / 16>(acc, dsa, desc_sw128_mn(stage_of(t), L::kKBox));
  };
  // P and dS of step t in place of its S and dP (both done).
  auto finish = [&](int t) {
    fence_acc(s);
    fence_acc(dp);
    if (t + 1 < nsteps) {
      row_probs<false>(s, nl, c, n - t * kStepK, tg);
    } else {
      row_probs<true>(s, nl, c, n - t * kStepK, tg);
    }
    row_dscores(dp, s, dl);
  };

  // Per step t: S and dP of step t + 1, then dQ of step t, are issued, and
  // P and dS of step t + 1 are computed while dQ of step t runs.
  mbar_wait(qd_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  scores(0);
  dprobs(0);
  wgmma_commit();
  wgmma_wait<0>();
  finish(0);
  pack_acc(dsa, dp);
  for (int t = 0; t + 1 < nsteps; ++t) {
    mbar_wait(&full[(t + 1) % S], ((t + 1) / S) & 1);
    wgmma_fence();
    scores(t + 1);
    dprobs(t + 1);
    wgmma_commit();
    grads(t);
    wgmma_commit();
    wgmma_wait<1>();
    finish(t + 1);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(dsa);
    mbar_arrive(&empty[t % S]);
    pack_acc(dsa, dp);
  }
  wgmma_fence();
  grads(nsteps - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + tg * 2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (base + row) * d + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------------ dk / dv

constexpr int kStepQ = 64;  // queries per step (rows of a Q or dO box)

// The dk/dv block's shape and its shared memory, from a 1024-byte aligned
// base: K's boxes, V's boxes, the ring (per stage: Q's boxes, dO's boxes,
// 64 values of L, 64 of D), the mbarriers.
template <int DP>
struct DkvLayout {
  // Consumer warpgroups of 64 key rows: two up to D = 48, where dK, dV, one
  // step's S^T and dP^T (or P^T and dS^T packed) fit the 168 registers a
  // thread that ptxas gives a block of more than 256 threads; one above
  // (186 registers at D = 64, 200 at D = 80).
  static constexpr int kWG = DP <= 48 ? 2 : 1;
  static constexpr int kBlockK = 64 * kWG;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  static constexpr int kBoxes = DP > 64 ? 2 : 1;
  static constexpr int kStages = kBoxes == 1 ? 4 : 3;
  static constexpr int kKBox = kBlockK * 128;  // one K or V box
  static constexpr int kQBox = kStepQ * 128;   // one Q or dO box, 8 KB
  static constexpr int kRowsOff = 2 * kBoxes * kQBox;
  static constexpr int kTx = kRowsOff + 2 * kStepQ * 4;  // bytes TMA brings a stage
  static constexpr int kStageBytes = (kTx + 1023) / 1024 * 1024;
  static constexpr int kKV = 2 * kBoxes * kKBox;
  static constexpr int kBar = kKV + kStages * kStageBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// P^T of one step in place of S^T. In the accumulator layout s[4i + 2j +
// e] is column (query) 8i + 2 tg + e of the step; `rows` holds the step's L
// (64 values) then its D. p = ex2(s * c - L * log2 e) with c = scale *
// log2 e. With kMask, queries >= `valid` get p = 0 (and so ds = 0), by
// selects.
template <bool kMask>
__device__ __forceinline__ void probs(float (&s)[32], const float* rows, float c, int valid,
                                      int tg) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(rows + 8 * i + 2 * tg);
    const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = j & 1;
      const float p = ex2(fmaf(s[4 * i + j], c, nl[e]));
      s[4 * i + j] = kMask && 8 * i + 2 * tg + e >= valid ? 0.f : p;
    }
  }
}

// dS^T = P^T * (dP^T - D) in place of dP^T, from P^T in p.
__device__ __forceinline__ void dscores(float (&dp)[32], const float (&p)[32], const float* rows,
                                        int tg) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 dl = *reinterpret_cast<const float2*>(rows + kStepQ + 8 * i + 2 * tg);
#pragma unroll
    for (int j = 0; j < 4; ++j) dp[4 * i + j] = p[4 * i + j] * (dp[4 * i + j] - (j & 1 ? dl.y : dl.x));
  }
}

// DP: the head dim rounded up to 16, the k extent of S^T and dP^T and the
// width of dV and dK.
template <int DP>
__global__ void __launch_bounds__(DkvLayout<DP>::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int n, int d, float c, float scale) {
  using L = DkvLayout<DP>;
  constexpr int S = L::kStages;
  constexpr int KS = DP / 16;  // k-steps of S^T and dP^T
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::kBoxes * L::kKBox;
  unsigned char* ring = smem + L::kKV;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * L::kBlockK;
  const int nsteps = (n + kStepQ - 1) / kStepQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == L::kConsumers / 32) {
    // Producer warp: one thread loads K and V once, then step t's Q, dO, L
    // and D into stage t % S once every consumer thread has released what
    // the stage held before.
    if (lane != 0) return;
    mbar_expect_tx(kv_full, L::kKV);
    for (int b = 0; b < L::kBoxes; ++b) {
      tma_load_3d(ks + b * L::kKBox, &tm_k, kv_full, b * kBox, k0, bh);
      tma_load_3d(vs + b * L::kKBox, &tm_v, kv_full, b * kBox, k0, bh);
    }
    for (int t = 0; t < nsteps; ++t) {
      const int stage = t % S;
      unsigned char* st = ring + stage * L::kStageBytes;
      mbar_wait(&empty[stage], ((t / S) & 1) ^ 1);
      mbar_expect_tx(&full[stage], L::kTx);
      for (int b = 0; b < L::kBoxes; ++b) {
        tma_load_3d(st + b * L::kQBox, &tm_q, &full[stage], b * kBox, t * kStepQ, bh);
        tma_load_3d(st + (L::kBoxes + b) * L::kQBox, &tm_do, &full[stage], b * kBox,
                    t * kStepQ, bh);
      }
      // (BH * N) vectors: a ragged last step reads the next head's first
      // values (or zeros past the end), which the mask drops
      const int row = bh * n + t * kStepQ;
      tma_load_1d(st + L::kRowsOff, &tm_lse, &full[stage], row);
      tma_load_1d(st + L::kRowsOff + kStepQ * 4, &tm_delta, &full[stage], row);
    }
    return;
  }

  // Consumers: warpgroup wg owns key rows 64wg..64wg+63 of the block; this
  // thread rows g and g + 8 of its warp's 16.
  const int wg = warp / 4;
  const int tg = lane & 3;

  float s[32];   // S^T, then P^T, of one step: 64 keys x 64 queries
  float dp[32];  // dP^T, then dS^T
  float dk_acc[DP / 2], dv_acc[DP / 2];
  uint32_t pa[16], dsa[16];  // P^T and dS^T in bf16: 4 k-steps of A fragments
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint64_t desc_k = desc_sw128(ks + wg * 64 * 128);
  const uint64_t desc_v = desc_sw128(vs + wg * 64 * 128);
  auto stage_of = [&](int t) { return ring + (t % S) * L::kStageBytes; };
  auto rows = [&](int t) { return reinterpret_cast<const float*>(stage_of(t) + L::kRowsOff); };
  // S^T = K Q^T, dP^T = V dO^T, and dV += P^T dO, dK += dS^T Q (dO and Q
  // MN-major), of step t
  auto scores = [&](int t) {
    ss_product<kStepQ, KS, L::kKBox, L::kQBox>(s, desc_k, desc_sw128(stage_of(t)));
  };
  auto dprobs = [&](int t) {
    ss_product<kStepQ, KS, L::kKBox, L::kQBox>(
        dp, desc_v, desc_sw128(stage_of(t) + L::kBoxes * L::kQBox));
  };
  auto grads = [&](int t) {
    unsigned char* st = stage_of(t);
    rs_product<DP, kStepQ / 16>(dv_acc, pa,
                                desc_sw128_mn(st + L::kBoxes * L::kQBox, L::kQBox));
    rs_product<DP, kStepQ / 16>(dk_acc, dsa, desc_sw128_mn(st, L::kQBox));
  };
  // dP^T of step t (S^T already issued): P^T is computed while dP^T runs,
  // then dS^T, and both are packed.
  auto finish = [&](int t) {
    wgmma_fence();
    dprobs(t);
    wgmma_commit();
    if (t + 1 < nsteps) {
      probs<false>(s, rows(t), c, n - t * kStepQ, tg);
    } else {
      probs<true>(s, rows(t), c, n - t * kStepQ, tg);
    }
    wgmma_wait<0>();
    fence_acc(dp);
    dscores(dp, s, rows(t), tg);
    pack_acc(pa, s);
    pack_acc(dsa, dp);
  };

  // Per step t: dV and dK of step t and S^T of step t + 1 are issued
  // together, then dP^T of step t + 1, under which P^T of step t + 1 is
  // computed. dP^T is never in flight beside the packed P^T and dS^T of the
  // step before, so the live registers stay within the 168 a thread of a
  // block of more than 256 threads gets.
  mbar_wait(kv_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  finish(0);
  for (int t = 0; t + 1 < nsteps; ++t) {
    mbar_wait(&full[(t + 1) % S], ((t + 1) / S) & 1);
    wgmma_fence();
    grads(t);
    scores(t + 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    fence_acc(pa);
    fence_acc(dsa);
    fence_acc(s);
    mbar_arrive(&empty[t % S]);
    finish(t + 1);
  }
  wgmma_fence();
  grads(nsteps - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dv_acc);
  fence_acc(dk_acc);

  const size_t base = (size_t)bh * n;
  const int row0 = k0 + wg * 64 + (warp % 4) * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + tg * 2;
      if (col < d) {
        const size_t off = (base + row) * d + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
            dk_acc[4 * i + 2 * r] * scale, dk_acc[4 * i + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
      }
    }
  }
}

// L or D as a 1-D fp32 tensor map over all BH * N values; a box is one
// step's 64 values, zeros past the end.
CUresult encode_vec(EncodeTiled encode, CUtensorMap* map, const void* ptr, int len) {
  const cuuint64_t dims[1] = {(cuuint64_t)len};
  const cuuint64_t strides[1] = {(cuuint64_t)len * 4};  // (none for one dimension)
  const cuuint32_t box[1] = {kStepQ};
  const cuuint32_t ones[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int n, int d,
                      float scale, cudaStream_t stream) {
  using L = DqLayout<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (encode_rows(encode, &tm_q, q, bh, n, d, L::kBlockQ) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_k, k, bh, n, d, kStepK) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_v, v, bh, n, d, kStepK) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_do, dout, bh, n, d, L::kBlockQ) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + L::kBlockQ - 1) / L::kBlockQ, bh);
  flash_bwd_dq_kernel<DP><<<grid, L::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), n, d, scale * kLog2e, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int n,
                       int d, float scale, cudaStream_t stream) {
  using L = DkvLayout<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
  if (encode_rows(encode, &tm_q, q, bh, n, d, kStepQ) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_k, k, bh, n, d, L::kBlockK) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_v, v, bh, n, d, L::kBlockK) != CUDA_SUCCESS ||
      encode_rows(encode, &tm_do, dout, bh, n, d, kStepQ) != CUDA_SUCCESS ||
      encode_vec(encode, &tm_lse, lse, bh * n) != CUDA_SUCCESS ||
      encode_vec(encode, &tm_delta, delta, bh * n) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + L::kBlockK - 1) / L::kBlockK, bh);
  flash_bwd_dkv_kernel<DP><<<grid, L::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, d, scale * kLog2e, scale);
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
