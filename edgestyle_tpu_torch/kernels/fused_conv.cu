// Fused GroupNorm-affine -> SiLU -> 3x3 convolution for Hopper (sm_90a).
//
// Replaces edgestyle_tpu/ops/fused_conv.py::_kernel (launched by
// _pallas_forward, wrapped by _fused and norm_act_conv3x3). Computes
//     out = conv3x3(silu(x * s + t), w) + bias        (stride 1, zero pad 1)
// where s, t are the per-(batch, channel) fp32 GroupNorm scale and shift
// that the caller folds from the statistics (ops/fused_conv.py), so the
// normalised, activated image never touches device memory.
//
// Design: an implicit GEMM with M = B*H*W output pixels, N = Cout and
// K = 9*Cin (tap-major, then channel). Each block computes a 128 x 128
// output tile with 8 warps (each 32 x 64) using ldmatrix + mma.sync
// m16n8k16 bf16 -> fp32. The K loop walks 64-channel slices (32 when Cin
// is not a multiple of 64) of the 9 taps through a 3-stage ring of
// shared-memory tiles filled with cp.async, so the loads of slice k+2
// overlap the products of slice k. A slice of A
// lands raw (a tap outside the image is zero-filled by the copy); before
// it is used, the thread that copied each 8-channel chunk rewrites it in
// place as bf16(silu(x * s + t)) in fp32, as the Pallas kernel casts the
// activation to x's type before the matmul. Chunks of padded taps are left
// at 0: the zero padding belongs to the *activated* image, so it must not
// become silu(0 * s + t) = silu(t).
//
// Bound on the H100: K = 9*Cin >= 1152 makes every SD1.5 shape do far more
// than 295 flops per byte moved, so the tensor cores bound it. The low-
// resolution levels have few output tiles (8x8 at batch 2 is one 128-row
// tile), so when the grid would not fill the card the K loop is split
// over gridDim.z: each split writes fp32 partial sums to a workspace and a
// second small kernel adds them with the bias. Times are in PERF.md.
//
// Layouts (plain C interface, loaded with ctypes):
//   x    (B, H, W, Cin)  bf16   -- a channels_last NCHW tensor
//   s, t (B, Cin)        fp32
//   w    (Cout, 3, 3, Cin) bf16 -- a channels_last OIHW tensor
//   bias (Cout)          fp32
//   out  (B, H, W, Cout) bf16
//   ws   (splits, B*H*W, Cout) fp32 workspace, used when splits > 1
// Requires Cin % 32 == 0 and Cout % 8 == 0. Returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kStages = 3;
constexpr int kThreads = 256;

// K slice of BK channels (64 when Cin allows, else 32). Shared rows are
// padded by 8 elements (144 or 80 bytes), which keeps ldmatrix conflict-free.
template <int BK>
struct Tile {
  static constexpr int LD = BK + 8;
  static constexpr int kStageElems = (kBM + kBN) * LD;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  static constexpr int kChunks = BK / 8;               // 16-byte chunks per row
  static constexpr int kRowStep = kThreads / kChunks;  // rows one pass covers
  static constexpr int kPasses = kBM / kRowStep;       // chunks per thread per operand
};

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte async copy; copies nothing and zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// silu(a) = a / (1 + exp(-a)) in fp32, as the Pallas kernel computes it.
// Every A element is activated once per tap and per Cout tile, so this is
// the kernel's second-largest cost after the products. The exponential
// (ex2.approx) and the division (rcp.approx) are the hardware's fast forms,
// a few fp32 ulps from exact: that moves a bf16 rounding of the activation
// only where the exact value lies that close to a rounding midpoint.
// (h + h * tanh.approx(h) with h = a / 2 is cheaper, but tanh.approx's
// absolute error of ~2^-11 is a large relative error of 1 + tanh(h) for
// a < -2.) chip_smoke.py counts the activations that round otherwise.
__device__ __forceinline__ float silu(float a) { return __fdividef(a, 1.0f + __expf(-a)); }

struct Geometry {
  int B, H, W, cin, cout, M, cslices;
};

template <int BK>
__global__ void __launch_bounds__(kThreads, 2)
fused_gn_silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ s,
                             const float* __restrict__ t, const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ ws, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bm = blockIdx.x * kBM;
  const int bn = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 64;

  // K range of this split
  const int KT = 9 * g.cslices;
  const int kt0 = (int)(((long long)blockIdx.z * KT) / gridDim.z);
  const int kt1 = (int)(((long long)(blockIdx.z + 1) * KT) / gridDim.z);
  const int nkt = kt1 - kt0;

  using T = Tile<BK>;
  constexpr int LD = T::LD;
  constexpr int P = T::kPasses;
  // Each thread copies P 8-channel chunks of A (rows r, r + kRowStep, ...)
  // and P of B, at the same column offset, for every slice.
  const int lrow = tid / T::kChunks;
  const int lcol = (tid % T::kChunks) * 8;
  int pb[P], ph[P], pw[P];
  bool pin[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int m = bm + lrow + i * T::kRowStep;
    pin[i] = m < g.M;
    const int mm = pin[i] ? m : 0;
    pb[i] = mm / (g.H * g.W);
    ph[i] = (mm / g.W) % g.H;
    pw[i] = mm % g.W;
  }

  auto tap_valid = [&](int i, int tap) {
    const int ih = ph[i] + tap / 3 - 1;
    const int iw = pw[i] + tap % 3 - 1;
    return pin[i] && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
  };

  auto issue = [&](int kt, int stage) {
    const int tap = kt / g.cslices;
    const int c0 = (kt % g.cslices) * BK + lcol;
    __nv_bfloat16* as = smem + stage * T::kStageElems;
    __nv_bfloat16* bs = as + kBM * LD;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const bool va = tap_valid(i, tap);
      const __nv_bfloat16* src = x;
      if (va) {
        const int ih = ph[i] + tap / 3 - 1;
        const int iw = pw[i] + tap % 3 - 1;
        src = x + ((size_t)(pb[i] * g.H + ih) * g.W + iw) * g.cin + c0;
      }
      cp_async16(as + (lrow + i * T::kRowStep) * LD + lcol, src, va);
      const int co = bn + lrow + i * T::kRowStep;
      const bool vb = co < g.cout;
      cp_async16(bs + (lrow + i * T::kRowStep) * LD + lcol,
                 vb ? w + ((size_t)co * 9 + tap) * g.cin + c0 : w, vb);
    }
  };

  auto activate = [&](int kt, int stage) {
    const int tap = kt / g.cslices;
    const int c = (kt % g.cslices) * BK + lcol;
    __nv_bfloat16* as = smem + stage * T::kStageElems;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (!tap_valid(i, tap)) continue;  // padded tap: stays the activated zero
      uint4* p = reinterpret_cast<uint4*>(as + (lrow + i * T::kRowStep) * LD + lcol);
      uint4 raw = *p;
      const float4* sp = reinterpret_cast<const float4*>(s + (size_t)pb[i] * g.cin + c);
      const float4* tp = reinterpret_cast<const float4*>(t + (size_t)pb[i] * g.cin + c);
      const float4 s0 = sp[0], s1 = sp[1], t0 = tp[0], t1 = tp[1];
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float sh[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v[e]);
        v[e] = __floats2bfloat162_rn(silu(f.x * sc[2 * e] + sh[2 * e]),
                                     silu(f.y * sc[2 * e + 1] + sh[2 * e + 1]));
      }
      *p = raw;
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) issue(kt0 + st, st);
    cp_async_commit();
  }

  for (int i = 0; i < nkt; ++i) {
    const int stage = i % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of slice i have landed
    activate(kt0 + i, stage);
    __syncthreads();               // every chunk of slice i is activated; slice i-1 is consumed
    const int nxt = i + kStages - 1;
    if (nxt < nkt) issue(kt0 + nxt, nxt % kStages);
    cp_async_commit();

    const __nv_bfloat16* as = smem + stage * T::kStageElems;
    const __nv_bfloat16* bs = as + kBM * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4(a[mt], as + (wm + mt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, bs + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = bm + wm + mt * 16 + gq + r * 8;
      if (m >= g.M) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = bn + wn + nt * 8 + tg * 2;
        if (co >= g.cout) continue;
        const float v0 = acc[mt][nt][2 * r];
        const float v1 = acc[mt][nt][2 * r + 1];
        if (gridDim.z == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * g.cout + co) =
              __floats2bfloat162_rn(v0 + bias[co], v1 + bias[co + 1]);
        } else {
          *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * g.M + m) * g.cout + co) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// out = bf16(sum over splits of ws + bias), two channels per thread.
__global__ void split_sum_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out, int splits, int M, int cout) {
  const long long pairs = (long long)M * cout / 2;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < pairs;
       p += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * p;
    const int co = (int)(e % cout);
    float2 acc = make_float2(bias[co], bias[co + 1]);
    for (int z = 0; z < splits; ++z) {
      const float2 v = *reinterpret_cast<const float2*>(ws + (size_t)z * M * cout + e);
      acc.x += v.x;
      acc.y += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(acc.x, acc.y);
  }
}

template <int BK>
cudaError_t launch_conv(const void* x, const void* s, const void* t, const void* w,
                        const void* bias, void* out, void* ws, const Geometry& g, int splits,
                        cudaStream_t st) {
  constexpr int smem = Tile<BK>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_gn_silu_conv3x3_kernel<BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((g.M + kBM - 1) / kBM), (unsigned)((g.cout + kBN - 1) / kBN),
            (unsigned)splits);
  fused_gn_silu_conv3x3_kernel<BK><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      g);
  return cudaGetLastError();
}

}  // namespace

// K slices are 64 channels when Cin % 64 == 0, else 32; `splits` must not
// exceed the slice count 9 * Cin / slice.
extern "C" int fused_gn_silu_conv3x3(const void* x, const void* s, const void* t, const void* w,
                                     const void* bias, void* out, void* ws, int B, int H, int W,
                                     int cin, int cout, int splits, void* stream) {
  const int bk = cin % 64 == 0 ? 64 : 32;
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || cin % 32 != 0 || cout % 8 != 0 ||
      splits < 1 || splits > 9 * (cin / bk)) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{B, H, W, cin, cout, B * H * W, cin / bk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bk == 64 ? launch_conv<64>(x, s, t, w, bias, out, ws, g, splits, st)
                             : launch_conv<32>(x, s, t, w, bias, out, ws, g, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pairs = (long long)g.M * cout / 2;
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  split_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                           static_cast<const float*>(bias),
                                           static_cast<__nv_bfloat16*>(out), splits, g.M, cout);
  return (int)cudaGetLastError();
}
