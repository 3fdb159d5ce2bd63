// GroupNorm statistics folded into the fused conv's scale and shift, in one
// launch, for Hopper (sm_90a).
//
// Replaces edgestyle_tpu/ops/fused_conv.py::_gn_scale_shift (which XLA
// reduces outside the Pallas kernel). For an image x (B, H, W, C) with G
// groups of C/G channels it writes, in fp32,
//     s[b, c] = gamma[c] * rsqrt(var[b, g] + eps)
//     t[b, c] = beta[c] - mean[b, g] * s[b, c]              (g = c / (C/G))
// with the moments of JAX's _moments (edgestyle_tpu/ops/norms.py): for bf16
// x the single-pass E[x^2] - E[x]^2 in fp32, clamped at 0; for fp32 x a
// variance of two-pass quality, from per-thread Welford updates merged with
// Chan's formula (never E[x^2] - E[x]^2, which cancels when the mean is
// large against the spread).
//
// Bound on the H100: the bytes of x, read once (67 MB at (1,128,512,512)
// bf16: 20 us at 3.35 TB/s). So x is read with 16-byte loads, four in
// flight per thread, and the work is spread over gridDim.x blocks per image
// (B*G can be as small as 32): each block reduces a range of pixels for all
// channels to one partial per group, and the last block of each image to
// finish (found by an atomic counter, which it resets to 0) merges the
// partials in a fixed order and writes s, t. Every merge runs in a fixed
// order and no float atomics are used, so the result is deterministic.
//
// Layouts (plain C interface, loaded with ctypes):
//   x     (B, H*W, C) bf16 or fp32 -- a channels_last NCHW tensor
//   gamma, beta (C) fp32
//   s, t  (B, C) fp32
//   ws    (B, G, chunks, 3) fp32 partials
//   counters (B) int32, zero on entry, zero on exit
// Requires C % G == 0 and 16-byte channel vectors (C % 8 for bf16, C % 4
// for fp32). Returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // 16-byte loads of x in flight per thread
constexpr int kMergeLoads = 8;  // partials in flight per lane in the final merge

// Single-pass sums (bf16 x): merging is addition.
struct Sums {
  float s = 0.f, q = 0.f;
  __device__ void push(float v, float) {
    s += v;
    q = fmaf(v, v, q);
  }
  __device__ void merge(const Sums& o) {
    s += o.s;
    q += o.q;
  }
  __device__ Sums shfl_down(int off) const {
    Sums o;
    o.s = __shfl_down_sync(0xffffffffu, s, off);
    o.q = __shfl_down_sync(0xffffffffu, q, off);
    return o;
  }
  __device__ void store(float* p) const {
    p[0] = s;
    p[1] = q;
    p[2] = 0.f;
  }
  __device__ static Sums read(const float* p) {  // shared memory
    Sums a;
    a.s = p[0];
    a.q = p[1];
    return a;
  }
  __device__ static Sums load(const float* p) {  // another block's partial: past L1
    Sums a;
    a.s = __ldcg(p);
    a.q = __ldcg(p + 1);
    return a;
  }
  __device__ void finish(float n, float& mean, float& var) const {
    mean = s / n;
    var = fmaxf(q / n - mean * mean, 0.f);
  }
};

// Count, mean and sum of squared deviations (fp32 x): Welford per value,
// Chan et al. to merge.
struct Welford {
  float n = 0.f, mean = 0.f, m2 = 0.f;
  __device__ void push(float v, float inv_n) {  // inv_n = 1 / (n + 1)
    n += 1.f;
    const float d = v - mean;
    mean = fmaf(d, inv_n, mean);
    m2 = fmaf(d, v - mean, m2);
  }
  __device__ void merge(const Welford& o) {
    if (o.n == 0.f) return;
    if (n == 0.f) {
      *this = o;
      return;
    }
    const float nn = n + o.n;
    const float d = o.mean - mean;
    const float f = o.n / nn;
    mean = fmaf(d, f, mean);
    m2 = m2 + o.m2 + d * d * n * f;
    n = nn;
  }
  __device__ Welford shfl_down(int off) const {
    Welford o;
    o.n = __shfl_down_sync(0xffffffffu, n, off);
    o.mean = __shfl_down_sync(0xffffffffu, mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, m2, off);
    return o;
  }
  __device__ void store(float* p) const {
    p[0] = n;
    p[1] = mean;
    p[2] = m2;
  }
  __device__ static Welford read(const float* p) {
    Welford a;
    a.n = p[0];
    a.mean = p[1];
    a.m2 = p[2];
    return a;
  }
  __device__ static Welford load(const float* p) {
    Welford a;
    a.n = __ldcg(p);
    a.mean = __ldcg(p + 1);
    a.m2 = __ldcg(p + 2);
    return a;
  }
  __device__ void finish(float, float& m, float& var) const {
    m = mean;
    var = n > 0.f ? m2 / n : 0.f;
  }
};

template <typename TX>
struct Vec;  // one 16-byte load of x as fp32 values

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float v[N]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float v[N]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

template <typename Acc>
__device__ __forceinline__ Acc warp_merge(Acc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a.merge(a.shfl_down(off));
  return a;  // lane 0 holds the merge of lanes 0..31, in a fixed tree order
}

// Grid (chunks, B). Block (k, b) reduces pixels [HW*k/chunks, HW*(k+1)/chunks)
// of image b. Its threads are laid out as R rows of NV 16-byte channel
// vectors (R = 256 / NV, or 1 with each thread taking several vectors when
// a pixel has more than 256), so neighbouring threads read neighbouring
// vectors of one pixel.
template <typename TX, typename Acc>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ s, float* __restrict__ t,
                float* __restrict__ ws, int* __restrict__ counters, int HW, int C, int G,
                float eps) {
  extern __shared__ float part[];  // (R, C) partials of 3 floats, then 2 * G floats
  constexpr int V = Vec<TX>::N;
  const int b = blockIdx.y;
  const int k = blockIdx.x;
  const int nk = gridDim.x;
  const int p0 = (int)((long long)HW * k / nk);
  const int p1 = (int)((long long)HW * (k + 1) / nk);
  const int NV = C / V;
  const int R = NV >= kThreads ? 1 : kThreads / NV;
  const TX* xb = x + (size_t)b * HW * C;

  // 1. Per (row, vector): the pixels p0 + r, p0 + r + R, ... of this chunk.
  for (int idx = threadIdx.x; idx < R * NV; idx += kThreads) {
    const int r = idx / NV;
    const int v = idx % NV;
    Acc acc[V];
    int p = p0 + r;
    float n = 0.f;
    for (; p + (kUnroll - 1) * R < p1; p += kUnroll * R) {
      float vals[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Vec<TX>::load(xb + (size_t)(p + u * R) * C + v * V, vals[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        n += 1.f;
        const float inv = 1.f / n;
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j].push(vals[u][j], inv);
      }
    }
    for (; p < p1; p += R) {
      float vals[V];
      Vec<TX>::load(xb + (size_t)p * C + v * V, vals);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j].push(vals[j], inv);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j].store(part + ((size_t)r * C + v * V + j) * 3);
  }
  __syncthreads();

  // 2. One warp per group: merge its R * C/G partials, write the block's one.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cg = C / G;
  for (int g = warp; g < G; g += kThreads / 32) {
    Acc a;
    for (int i = lane; i < R * cg; i += 32) {
      const int r = i / cg;
      const int c = g * cg + i % cg;
      a.merge(Acc::read(part + ((size_t)r * C + c) * 3));
    }
    a = warp_merge(a);
    if (lane == 0) a.store(ws + (((size_t)b * G + g) * nk + k) * 3);
  }

  // 3. The last block of image b to get here merges the nk partials.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[b], 1) == nk - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* mean_g = part;
  float* rstd_g = part + G;
  const float n_group = (float)HW * cg;
  for (int g = warp; g < G; g += kThreads / 32) {
    const float* wg = ws + ((size_t)b * G + g) * nk * 3;
    Acc a;
    for (int i0 = lane; i0 < nk; i0 += 32 * kMergeLoads) {
      Acc part_i[kMergeLoads];  // loaded together: one L2 round trip per kMergeLoads partials
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        if (i0 + 32 * u < nk) part_i[u] = Acc::load(wg + (size_t)(i0 + 32 * u) * 3);
      }
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) a.merge(part_i[u]);
    }
    a = warp_merge(a);
    if (lane == 0) {
      float m, var;
      a.finish(n_group, m, var);
      mean_g[g] = m;
      rstd_g[g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g = c / cg;
    const float sc = gamma[c] * rstd_g[g];
    s[(size_t)b * C + c] = sc;
    t[(size_t)b * C + c] = beta[c] - mean_g[g] * sc;
  }
  if (threadIdx.x == 0) counters[b] = 0;
}

template <typename TX, typename Acc>
cudaError_t launch(const void* x, const float* gamma, const float* beta, float* s, float* t,
                   float* ws, int* counters, int B, int HW, int C, int G, int chunks, float eps,
                   cudaStream_t st) {
  constexpr int V = Vec<TX>::N;
  const int NV = C / V;
  const int R = NV >= kThreads ? 1 : kThreads / NV;
  const size_t smem = (size_t)R * C * 3 * sizeof(float);
  if (smem > 48 * 1024 || 2 * G > R * C * 3) return cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)B);
  gn_stats_kernel<TX, Acc><<<grid, kThreads, smem, st>>>(static_cast<const TX*>(x), gamma, beta,
                                                           s, t, ws, counters, HW, C, G, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gn_scale_shift(const void* x, int x_f32, const void* gamma, const void* beta,
                              void* s, void* t, void* ws, void* counters, int B, int HW, int C,
                              int G, int chunks, float eps, void* stream) {
  const int V = x_f32 ? 4 : 8;
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || C % V != 0 || chunks < 1 ||
      chunks > HW) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto be = static_cast<const float*>(beta);
  auto sp = static_cast<float*>(s);
  auto tp = static_cast<float*>(t);
  auto w = static_cast<float*>(ws);
  auto cnt = static_cast<int*>(counters);
  cudaError_t err =
      x_f32 ? launch<float, Welford>(x, g, be, sp, tp, w, cnt, B, HW, C, G, chunks, eps, st)
            : launch<__nv_bfloat16, Sums>(x, g, be, sp, tp, w, cnt, B, HW, C, G, chunks, eps, st);
  return (int)err;
}
