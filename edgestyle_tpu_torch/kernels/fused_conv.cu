// Fused GroupNorm-affine -> SiLU -> 3x3 convolution for Hopper (sm_90a).
//
// Replaces edgestyle_tpu/ops/fused_conv.py::_kernel (launched by
// _pallas_forward, wrapped by _fused and norm_act_conv3x3). Computes
//     out = conv3x3(bf16(silu(x * s + t)), w) + bias        (stride 1, zero pad 1)
// where s, t are the per-(batch, channel) fp32 GroupNorm scale and shift
// (kernels/gn_stats.cu) and x is bf16 or fp32, read in its own type, so the
// normalised, activated image never touches device memory.
//
// Bound on the H100: K = 9*Cin >= 1152 makes every SD1.5 shape do far more
// than 295 flops per byte moved, so the tensor cores bound it; the 8x8
// level at batch 2 is the exception, bound by the 9*Cin*Cout weight bytes.
// So the products run on wgmma, the only way to the card's tensor-core
// rate, and the activation, which runs on the SFU, is done once per input
// element and block and overlaps the products.
//
// Design: an implicit GEMM with M = output pixels, N = Cout and K = 9*Cin.
// A block owns an 8 x 16 pixel tile of one image (M = 128) and BN = 160
// output channels where Cout is a multiple of 160 (one wave of blocks at
// SD1.5's (2, 320, 64, 64), where 128 takes two), else 128. It runs 9
// warps: one producer warp issues every copy (TMA), two consumer
// warpgroups (64 pixels each) activate and multiply. The K
// loop runs 64-channel slices on the outside and the 9 taps on the inside:
//   - per slice, TMA copies the raw 10 x 18 halo of the tile (a 4-D box of
//     x in its own type, from signed start coordinates -1; out of the image
//     it fills zeros) into one of two raw buffers. The consumers activate it
//     once, bf16(silu(x * s + t)) in fp32, into one of two bf16 halo tiles
//     in shared memory, and read all 9 taps out of it as shifted views:
//     ldmatrix takes any row addresses, so it gives the A fragments of a
//     tap, which wgmma then takes from registers (a shared-memory
//     descriptor cannot describe a shifted view). Each activation is
//     computed once per block and slice, about 180 / 128 = 1.4 times per
//     Cout tile, where a per-tap activation of an A tile costs 9 times.
//   - slice c+1 is activated in 9 parts, one after each tap's wgmma of
//     slice c is issued, so the SFU work overlaps the tensor cores.
//   - per tap, TMA copies a BN x 64 weight tile (a 2-D box of w as a
//     (Cout, 9*Cin) matrix, 128-byte swizzle) into a 4-stage mbarrier
//     ring, which wgmma reads as its shared-memory B operand.
// Halo pixels outside the image are written as 0: the zero padding belongs
// to the *activated* image, so it must not become silu(0 * s + t) = silu(t).
// Channels past Cin (Cin % 64 != 0) are 0 in A, whatever B holds there.
// The activated halo tile has 128-byte rows (one pixel's 64 channels) whose
// 16-byte chunks are swizzled by pixel (chunk ^ pixel % 8): the eight
// consecutive pixels of one ldmatrix then hit eight different bank groups.
// When the tiles do not fill the card (the 8x8 and 16x16 levels), the
// slices are split over gridDim.z: each split writes fp32 partial sums to a
// workspace and a second small kernel adds them, with the bias, in a fixed
// order. The plan is chosen in ops/fused_conv.py::conv_plan. The tensor
// maps are encoded on the host per call, with cuTensorMapEncodeTiled looked
// up at run time (the library needs no -lcuda). Times are in PERF.md.
//
// Layouts (plain C interface, loaded with ctypes):
//   x    (B, H, W, Cin)   bf16 or fp32 -- a channels_last NCHW tensor
//   s, t (B, Cin)         fp32
//   w    (Cout, 3, 3, Cin) bf16        -- a channels_last OIHW tensor
//   bias (Cout)           bf16 or fp32
//   out  (B, H, W, Cout)  bf16
//   ws   (splits, B*H*W, Cout) fp32 workspace, used when splits > 1
// Requires Cin % 8 == 0 and Cout % 8 == 0. Returns the launch's cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTH = 8, kTW = 16;                     // output tile, pixels
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;    // its 3x3 halo
constexpr int kHalo = kHaloH * kHaloW;               // 180 pixels
constexpr int kBK = 64;                              // channels per slice
constexpr int kConsumers = 256;                      // two warpgroups
constexpr int kThreads = kConsumers + 32;            // and the producer warp
constexpr int kActBytes = kHalo * kBK * 2;           // 22.5 KB
constexpr int kActChunks = kHalo * kBK / 8;          // 16-byte chunks of a halo tile
constexpr int kActPart = kActChunks / 9;             // activated after each tap
static_assert(kActPart * 9 == kActChunks && kActPart % 8 == 0, "one part per tap");

constexpr int kStages = 4;                           // weight ring

// Shared memory, from a 1024-byte aligned base: the weight ring of BN x 64
// tiles, two activated halo tiles, two raw halo tiles, the mbarriers.
template <typename TX, int BN>
struct Layout {
  static constexpr int kStageBytes = BN * kBK * 2;
  static constexpr int kRawBytes = kHalo * kBK * (int)sizeof(TX);
  static constexpr int kAct = kStages * kStageBytes;
  static constexpr int kRaw = kAct + 2 * kActBytes;
  static constexpr int kBar = kRaw + 2 * kRawBytes;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 4) + 1024;
};

// D (64 x N fp32, the accumulator layout of m16n8 fragments repeated over
// N/8 column blocks: d[4i + 2j + k] is row 16 * warp + lane / 4 + 8j, column
// 8i + 2 * (lane % 4) + k) += A (64 x 16 bf16 from registers, each warp's 16
// rows as an mma.sync m16n8k16 A fragment) * B (16 x N bf16, K-major in
// shared memory, 128-byte swizzle, through its descriptor).
template <int N>
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_m64nk16<128>(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nk16<160>(float (&d)[80], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79 "
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Element offset of 16-byte chunk q of halo pixel `hp` in a swizzled tile.
__device__ __forceinline__ int swz(int hp, int q) { return hp * kBK + ((q ^ (hp & 7)) << 3); }

// silu(a) = a / (1 + exp(-a)) in fp32, as the Pallas kernel computes it. The
// exponential (ex2.approx) and the division (rcp.approx) are the hardware's
// fast forms, a few fp32 ulps from exact: that moves a bf16 rounding of the
// activation only where the exact value lies that close to a rounding
// midpoint. chip_smoke.py counts the activations that round otherwise.
__device__ __forceinline__ float silu(float a) { return __fdividef(a, 1.0f + __expf(-a)); }

// Eight consecutive raw channels as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

struct Geometry {
  int B, H, W, cin, cout, tiles_h, tiles_w, cslices, M, bias_f32;
};

template <typename TX, int BN>
__global__ void __launch_bounds__(kThreads, 1)
fused_gn_silu_conv3x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w,
                             const float* __restrict__ s, const float* __restrict__ t,
                             const void* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ ws, Geometry g) {
  using L = Layout<TX, BN>;
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + L::kAct);
  TX* raw = reinterpret_cast<TX*>(smem + L::kRaw);
  uint64_t* full_w = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty_w = full_w + kStages;
  uint64_t* full_raw = empty_w + kStages;
  uint64_t* empty_raw = full_raw + 2;

  const int tw_i = blockIdx.x % g.tiles_w;
  const int th_i = (blockIdx.x / g.tiles_w) % g.tiles_h;
  const int b = blockIdx.x / (g.tiles_w * g.tiles_h);
  const int oh0 = th_i * kTH;
  const int ow0 = tw_i * kTW;
  const int bn = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // slices [cs0, cs0 + nsl) of this split, all 9 taps each
  const int cs0 = (int)((long long)blockIdx.z * g.cslices / gridDim.z);
  const int nsl = (int)((long long)(blockIdx.z + 1) * g.cslices / gridDim.z) - cs0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_w[i], 1);
      mbar_init(&empty_w[i], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_raw[i], 1);
      mbar_init(&empty_raw[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: raw halos of slices 0 and 1, then per slice its 9 weight
    // tiles and the raw halo two slices on. Slice r's halo goes to raw
    // buffer r % 2, K step i's weights to stage i % kStages; a buffer is
    // refilled once every consumer warp has released it.
    if (lane != 0) return;
    auto load_raw = [&](int r) {
      const int buf = r & 1;
      mbar_wait(&empty_raw[buf], ((r >> 1) & 1) ^ 1);
      mbar_expect_tx(&full_raw[buf], L::kRawBytes);
      tma_load_4d(raw + buf * (kHalo * kBK), &tm_x, &full_raw[buf], (cs0 + r) * kBK, ow0 - 1,
                  oh0 - 1, b);
    };
    load_raw(0);
    if (nsl > 1) load_raw(1);
    for (int r = 0; r < nsl; ++r) {
      for (int tap = 0; tap < 9; ++tap) {
        const int i = r * 9 + tap;
        const int stage = i % kStages;
        mbar_wait(&empty_w[stage], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_w[stage], L::kStageBytes);
        tma_load_2d(wst + stage * (BN * kBK), &tm_w, &full_w[stage],
                    tap * g.cin + (cs0 + r) * kBK, bn);
      }
      if (r + 2 < nsl) load_raw(r + 2);
    }
    return;
  }

  // Consumers. Warpgroup wg owns tile rows 4wg..4wg+3; warp wi of it one row.
  const int wg = warp / 4;
  const int wi = warp % 4;
  const int j = tid & 7;  // the 16-byte chunk this thread activates, fixed
  float sc[8], sh[8];
  auto load_st = [&](int cs) {  // s, t of the chunk's 8 channels in slice cs
    const int c = cs * kBK + j * 8;
    if (c >= g.cin) return;
    const float4* sp = reinterpret_cast<const float4*>(s + (size_t)b * g.cin + c);
    const float4* tp = reinterpret_cast<const float4*>(t + (size_t)b * g.cin + c);
    const float4 s0 = sp[0], s1 = sp[1], t0 = tp[0], t1 = tp[1];
    sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
    sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
    sh[0] = t0.x, sh[1] = t0.y, sh[2] = t0.z, sh[3] = t0.w;
    sh[4] = t1.x, sh[5] = t1.y, sh[6] = t1.z, sh[7] = t1.w;
  };
  // bf16(silu(x * s + t)) of chunks [i0, i1) of slice r's raw halo into its
  // activated tile; pixels outside the image and channels past Cin are 0.
  auto activate = [&](int r, int i0, int i1) {
    const TX* rb = raw + (r & 1) * (kHalo * kBK);
    __nv_bfloat16* ab = act + (r & 1) * (kHalo * kBK);
    const bool cok = (cs0 + r) * kBK + j * 8 < g.cin;
    for (int i = i0 + tid; i < i1; i += kConsumers) {
      const int hp = i >> 3;
      const int ih = oh0 - 1 + hp / kHaloW;
      const int iw = ow0 - 1 + hp % kHaloW;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (cok && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
        float v[8];
        load8(rb + hp * kBK + j * 8, v);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = __floats2bfloat162_rn(silu(fmaf(v[2 * e], sc[2 * e], sh[2 * e])),
                                       silu(fmaf(v[2 * e + 1], sc[2 * e + 1], sh[2 * e + 1])));
        }
      }
      *reinterpret_cast<uint4*>(ab + swz(hp, j)) = packed;
    }
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  mbar_wait(&full_raw[0], 0);
  load_st(cs0);
  activate(0, 0, kActChunks);
  release(&empty_raw[0]);
  consumers_sync();

  const int row = 4 * wg + wi;  // this warp's tile row
  for (int r = 0; r < nsl; ++r) {
    const bool next = r + 1 < nsl;
    if (next) {
      mbar_wait(&full_raw[(r + 1) & 1], ((r + 1) >> 1) & 1);
      load_st(cs0 + r + 1);
    }
    const __nv_bfloat16* ab = act + (r & 1) * (kHalo * kBK);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int i = r * 9 + tap;
      const int stage = i % kStages;
      const int hp = (row + tap / 3) * kHaloW + (lane & 15) + tap % 3;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], ab + swz(hp, kk * 2 + (lane >> 4)));
      mbar_wait(&full_w[stage], (i / kStages) & 1);
      const uint64_t desc = desc_sw128(wst + stage * (BN * kBK));
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64nk16<BN>(acc, a[kk], desc + 2 * kk);
      wgmma_commit();
      fence_acc(acc);
      // the next slice's activation, a ninth per tap, while the products run
      if (next) activate(r + 1, tap * kActPart, (tap + 1) * kActPart);
      __syncwarp();
      wgmma_wait<0>();
      fence_acc(acc);
      release(&empty_w[stage]);
    }
    if (next) {
      release(&empty_raw[(r + 1) & 1]);
      consumers_sync();  // slice r+1 activated; every warp is done reading slice r's tile
    }
  }

  const int gq = lane >> 2;
  const int tg = lane & 3;
  const int oh = oh0 + row;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int ow = ow0 + gq + 8 * jj;
    if (oh >= g.H || ow >= g.W) continue;
    const size_t m = ((size_t)b * g.H + oh) * g.W + ow;
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const int co = bn + n8 * 8 + tg * 2;
      if (co >= g.cout) continue;
      const float v0 = acc[4 * n8 + 2 * jj];
      const float v1 = acc[4 * n8 + 2 * jj + 1];
      if (gridDim.z == 1) {
        float b0, b1;
        if (g.bias_f32) {
          b0 = static_cast<const float*>(bias)[co];
          b1 = static_cast<const float*>(bias)[co + 1];
        } else {
          b0 = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co]);
          b1 = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + m * g.cout + co) =
            __floats2bfloat162_rn(v0 + b0, v1 + b1);
      } else {
        *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * g.M + m) * g.cout + co) =
            make_float2(v0, v1);
      }
    }
  }
}

// out = bf16(sum over splits of ws, in split order, + bias), two channels per thread.
__global__ void split_sum_kernel(const float* __restrict__ ws, const void* __restrict__ bias,
                                 int bias_f32, __nv_bfloat16* __restrict__ out, int splits, int M,
                                 int cout) {
  const long long pairs = (long long)M * cout / 2;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < pairs;
       p += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * p;
    const int co = (int)(e % cout);
    float2 acc = make_float2(0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float2 v = *reinterpret_cast<const float2*>(ws + (size_t)z * M * cout + e);
      acc.x += v.x;
      acc.y += v.y;
    }
    if (bias_f32) {
      acc.x += static_cast<const float*>(bias)[co];
      acc.y += static_cast<const float*>(bias)[co + 1];
    } else {
      acc.x += __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co]);
      acc.y += __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co + 1]);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(acc.x, acc.y);
  }
}

template <typename TX, int BN>
cudaError_t launch_conv(const void* x, const void* s, const void* t, const void* w,
                        const void* bias, void* out, void* ws, const Geometry& g, int splits,
                        cudaStream_t st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t es = sizeof(TX);
  // x as (C, W, H, B), innermost first; a box is one slice of the halo
  CUtensorMap tm_x, tm_w;
  const cuuint64_t xdim[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.B};
  const cuuint64_t xstride[3] = {g.cin * es, (cuuint64_t)g.W * g.cin * es,
                                 (cuuint64_t)g.H * g.W * g.cin * es};
  const cuuint32_t xbox[4] = {kBK, kHaloW, kHaloH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&tm_x, sizeof(TX) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, const_cast<void*>(x), xdim, xstride, xbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // w as a (Cout, 9*Cin) matrix; a box is 128 output channels x 64 of K
  const cuuint64_t wdim[2] = {(cuuint64_t)9 * g.cin, (cuuint64_t)g.cout};
  const cuuint64_t wstride[1] = {(cuuint64_t)9 * g.cin * 2};
  const cuuint32_t wbox[2] = {kBK, BN};
  r = encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;

  constexpr int smem = Layout<TX, BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_gn_silu_conv3x3_kernel<TX, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(g.B * g.tiles_h * g.tiles_w), (unsigned)((g.cout + BN - 1) / BN),
            (unsigned)splits);
  fused_gn_silu_conv3x3_kernel<TX, BN><<<grid, kThreads, smem, st>>>(
      tm_x, tm_w, static_cast<const float*>(s), static_cast<const float*>(t), bias,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), g);
  return cudaGetLastError();
}

}  // namespace

// `bn`, the Cout tile, is 128 or 160; `splits` must not exceed the slice
// count ceil(Cin / 64).
extern "C" int fused_gn_silu_conv3x3(const void* x, int x_f32, const void* s, const void* t,
                                     const void* w, const void* bias, int bias_f32, void* out,
                                     void* ws, int B, int H, int W, int cin, int cout, int bn,
                                     int splits, void* stream) {
  const int cslices = (cin + kBK - 1) / kBK;
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || cin % 8 != 0 || cout % 8 != 0 ||
      (bn != 128 && bn != 160) || splits < 1 || splits > cslices) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{B, H, W, cin, cout, (H + kTH - 1) / kTH, (W + kTW - 1) / kTW, cslices, B * H * W,
             bias_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = x_f32 ? (bn == 160 ? launch_conv<float, 160> : launch_conv<float, 128>)
                      : (bn == 160 ? launch_conv<__nv_bfloat16, 160>
                                   : launch_conv<__nv_bfloat16, 128>);
  cudaError_t err = launch(x, s, t, w, bias, out, ws, g, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pairs = (long long)g.M * cout / 2;
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  split_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), bias, bias_f32,
                                           static_cast<__nv_bfloat16*>(out), splits, g.M, cout);
  return (int)cudaGetLastError();
}
