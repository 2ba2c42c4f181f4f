// K2: fused 3x3 conv + channel LayerNorm + activation (+ residual) on
// Hopper's bf16 tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel gwdepth_tpu/ops/fused_conv.py:
// conv3x3_ln_act (kernel _make_kernel, pallas_call at :378) as the model
// reaches it: fused_conv_ln_act and fused_conv_ln_act_frame run it with
// fast=True, bf16 taps and float32 accumulation, for the forward and for
// the backward's recompute and dx alike.
//
// Computes, on NHWC float32 x (B, H, W, Ci), no bias, stride 1, SAME zero
// borders:
//     y = act(LN_c(conv3x3(bf16(x), bf16(w))) * g + beta) [+ residual]
// LN over the Co channels of each pixel (eps 1e-5), optional (g == null
// skips it); act 0 = none, 1 = GELU (exact, erff), 2 = ELU; residual
// optional. x is rounded to bf16 (round to nearest even) on its way into
// shared memory; the wrapper hands w over already rounded. The product of
// two bf16 numbers is exact in float32 and the MMA accumulates in float32,
// so the kernel matches the plain version (x and w rounded the same way,
// float32 contraction) to reassociation.
//
// Bound on the H100: the main path's largest link (160 -> 160 on a
// 192 x 256 plane) is 22.6 GFLOP, 23 us at 989 TFLOP/s dense bf16,
// against 63 MB of float32 input and output, 19 us at 3.35 TB/s: the two
// are close, so the kernel has to keep the tensor cores fed and read x
// once from HBM.
//
// Design: an implicit GEMM, M = pixels, N = all Co (padded to NT * 8),
// K = 9 taps x Ci (Ci padded to a multiple of 16), on wgmma.
//  - A block of 4 or 8 warps (1 or 2 warpgroups) owns a tile of rows x 32
//    pixels of one image and ALL of its Co channels. Warps split M, never
//    N: warp w holds MT m16 tiles (16 pixels of one row each) x NT n8
//    tiles of float32 accumulators, so every pixel's Co values live in the
//    4 lanes of one quad and the LayerNorm reduces with two shuffles, in
//    registers. The m16 tiles of a warpgroup's 4 warps form the 64 rows of
//    one wgmma.m64nNk16 (N = Co padded), whose accumulator layout per warp
//    is that of mma.m16n8k16.
//  - K runs in chunks of 16 input channels. Per chunk the block stages
//    the (rows + 2) x 34 pixel halo of x in shared memory as bf16: each
//    thread reads its 16-byte groups of float32 x into registers (borders
//    and channels past Ci zero), rounds them (cvt.rn.bf16x2.f32) and stores
//    8 bytes each, 24 bf16 a pixel (no bank conflicts for ldmatrix). The
//    9 x Co x 16 bf16 weight slice (laid out by tile_weights_kernel in
//    wgmma's 8 x 16-byte core matrices) comes by cp.async. Both are double
//    buffered: chunk c + 1's x loads stay in registers and its weights fly
//    while chunk c multiplies; one barrier a chunk.
//  - Per tap, each warp loads its A fragments from the shifted halo rows
//    with one ldmatrix.x4 per m tile, then the warpgroup issues one
//    wgmma.mma_async per m tile with B read by the tensor cores from
//    shared memory through a descriptor. A alternates between two
//    register sets, so the next tap's loads overlap this tap's MMA.
//  - Epilogue: mean and variance over Co (two passes), scale and shift in
//    registers; then each warp stages its 16 x Co outputs in shared memory
//    and writes them, which are contiguous in NHWC, with coalesced stores
//    in a short loop that applies the activation and the residual (an
//    epilogue unrolled over every register made the kernel body hundreds
//    of KB, a fixed cost per launch whatever Ci was).
//  - The tile (MT, warps) is chosen per plane by a wave-count estimate
//    (choose_tile). The result does not depend on the tile: every output
//    sums the same products in the same order.
// Its times on an H100 beside the bound, and what holds it back: PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKC = 16;          // input channels per K chunk
constexpr int kTW = 32;          // pixels per tile row: two m16 tiles
constexpr int kHW = kTW + 2;     // halo row width
constexpr int kXS = 24;          // bf16 per staged halo pixel (16 + pad)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from global to shared memory
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src));
}

__device__ __forceinline__ uint32_t bf16x2(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x: low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// Shared-memory descriptor of one tap's B operand (N x 16 k, K-major, no
// swizzle): 8 x 16-byte core matrices, the two k halves of an 8-row group
// kLBO bytes apart, consecutive 8-row groups kSBO bytes apart.
constexpr uint32_t kLBO = 128, kSBO = 256;
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> float32, A from registers (per
// warp the m16n8k16 A fragment of its 16 rows), B from shared memory: D +=
// A * B, with D per warp in the m16n8k16 C layout of N / 8 n8 tiles, N / 2
// float registers. The operands are numbered A %0-%3, the B descriptor %4,
// the accumulate flag %5 (all read-write, so that their numbers do not
// depend on N), then D from %6 on: GW_Dk lists the first 8 * k of D's
// operands and GW_DOPSk their constraints.
#define GW_DS0 "%6, %7, %8, %9, %10, %11, %12, %13"
#define GW_DS1 ", %14, %15, %16, %17, %18, %19, %20, %21"
#define GW_DS2 ", %22, %23, %24, %25, %26, %27, %28, %29"
#define GW_DS3 ", %30, %31, %32, %33, %34, %35, %36, %37"
#define GW_DS4 ", %38, %39, %40, %41, %42, %43, %44, %45"
#define GW_DS5 ", %46, %47, %48, %49, %50, %51, %52, %53"
#define GW_DS6 ", %54, %55, %56, %57, %58, %59, %60, %61"
#define GW_DS7 ", %62, %63, %64, %65, %66, %67, %68, %69"
#define GW_DS8 ", %70, %71, %72, %73, %74, %75, %76, %77"
#define GW_DS9 ", %78, %79, %80, %81, %82, %83, %84, %85"
#define GW_DS10 ", %86, %87, %88, %89, %90, %91, %92, %93"
#define GW_DS11 ", %94, %95, %96, %97, %98, %99, %100, %101"
#define GW_DS12 ", %102, %103, %104, %105, %106, %107, %108, %109"
#define GW_DS13 ", %110, %111, %112, %113, %114, %115, %116, %117"
#define GW_DS14 ", %118, %119, %120, %121, %122, %123, %124, %125"
#define GW_DS15 ", %126, %127, %128, %129, %130, %131, %132, %133"
#define GW_DOP8(k) "+f"(d[8 * k]), "+f"(d[8 * k + 1]), "+f"(d[8 * k + 2]), \
    "+f"(d[8 * k + 3]), "+f"(d[8 * k + 4]), "+f"(d[8 * k + 5]),          \
    "+f"(d[8 * k + 6]), "+f"(d[8 * k + 7])
#define GW_D1 GW_DS0
#define GW_DOPS1 GW_DOP8(0)
#define GW_D2 GW_D1 GW_DS1
#define GW_DOPS2 GW_DOPS1, GW_DOP8(1)
#define GW_D3 GW_D2 GW_DS2
#define GW_DOPS3 GW_DOPS2, GW_DOP8(2)
#define GW_D4 GW_D3 GW_DS3
#define GW_DOPS4 GW_DOPS3, GW_DOP8(3)
#define GW_D5 GW_D4 GW_DS4
#define GW_DOPS5 GW_DOPS4, GW_DOP8(4)
#define GW_D6 GW_D5 GW_DS5
#define GW_DOPS6 GW_DOPS5, GW_DOP8(5)
#define GW_D7 GW_D6 GW_DS6
#define GW_DOPS7 GW_DOPS6, GW_DOP8(6)
#define GW_D8 GW_D7 GW_DS7
#define GW_DOPS8 GW_DOPS7, GW_DOP8(7)
#define GW_D9 GW_D8 GW_DS8
#define GW_DOPS9 GW_DOPS8, GW_DOP8(8)
#define GW_D10 GW_D9 GW_DS9
#define GW_DOPS10 GW_DOPS9, GW_DOP8(9)
#define GW_D11 GW_D10 GW_DS10
#define GW_DOPS11 GW_DOPS10, GW_DOP8(10)
#define GW_D12 GW_D11 GW_DS11
#define GW_DOPS12 GW_DOPS11, GW_DOP8(11)
#define GW_D13 GW_D12 GW_DS12
#define GW_DOPS13 GW_DOPS12, GW_DOP8(12)
#define GW_D14 GW_D13 GW_DS13
#define GW_DOPS14 GW_DOPS13, GW_DOP8(13)
#define GW_D15 GW_D14 GW_DS14
#define GW_DOPS15 GW_DOPS14, GW_DOP8(14)
#define GW_D16 GW_D15 GW_DS15
#define GW_DOPS16 GW_DOPS15, GW_DOP8(15)
template <int N> struct Wgmma;
#define GW_WGMMA(N, K)                                                      \
  template <> struct Wgmma<N> {                                             \
    __device__ __forceinline__ static void run(float* d, uint32_t* a,       \
                                               uint64_t desc) {             \
      int one = 1;                                                          \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "       \
          "{" GW_D##K "}, {%0, %1, %2, %3}, %4, p, 1, 1, 0;\n}\n"           \
          : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+l"(desc),     \
            "+r"(one), GW_DOPS##K);                                         \
    }                                                                       \
  };
GW_WGMMA(16, 1)
GW_WGMMA(32, 2)
GW_WGMMA(48, 3)
GW_WGMMA(64, 4)
GW_WGMMA(80, 5)
GW_WGMMA(96, 6)
GW_WGMMA(128, 8)
GW_WGMMA(160, 10)
GW_WGMMA(192, 12)
GW_WGMMA(256, 16)

__device__ __forceinline__ float act_fn(float t, int act) {
  if (act == 1) return 0.5f * t * (1.0f + erff(t * 0.70710678118654752f));
  if (act == 2) return t > 0.f ? t : expm1f(t);
  return t;
}

struct Args {
  const float* x;              // (B, H, W, Ci) float32
  const __nv_bfloat16* w;      // (nchunk, 9, co_pad, 16) bf16
  const float* g;              // (Co,) or null
  const float* beta;           // (Co,)
  const float* res;            // (B, H, W, Co) or null
  float* y;                    // (B, H, W, Co)
  int H, W, Ci, Co, act, vec, rows, nchunk;
};

// 16-byte groups of x per thread that one chunk's halo needs: (rows + 2)
// x 34 pixels x 4 groups over the block's threads (rows 2, 4 or 8 with 4,
// 8 or 8 warps)
template <int MT> __host__ __device__ constexpr int prefetch_groups() {
  return MT == 2 ? 6 : 5;
}

template <int NT, int MT>
__global__ void __launch_bounds__(256, 1)
conv3x3_ln_act_kernel(const Args a) {
  constexpr int CP = NT * 8;
  constexpr int PF = prefetch_groups<MT>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int hp = (a.rows + 2) * kHW;           // halo pixels
  float* gs = reinterpret_cast<float*>(smem);  // [CP] LN scale
  float* bs = gs + CP;                         // [CP] LN shift
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(bs + CP);
  __nv_bfloat16* ws = xs + 2 * hp * kXS;       // xs: [2][hp][kXS]

  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * a.rows;
  const int b = blockIdx.z;
  const float* xb = a.x + (size_t)b * a.H * a.W * a.Ci;

  for (int i = tid; i < CP; i += nthreads) {
    const bool ok = a.g != nullptr && i < a.Co;
    gs[i] = ok ? a.g[i] : 0.f;
    bs[i] = ok ? a.beta[i] : 0.f;
  }

  // x of chunk ch into registers: this thread's groups of 4 channels of
  // the halo (item i: pixel i / 4, channels c0 + 4 (i % 4) ...), zero past
  // the borders and past Ci, read as vec-float pieces
  float4 pf[PF];
  auto load_x = [&](int ch) {
    const int c0 = ch * kKC, vec = a.vec;
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int i = tid + k * nthreads;
      const int p = i >> 2, c = c0 + 4 * (i & 3);
      const int yy = y0 + p / kHW - 1, xx = x0 + p % kHW - 1;
      const bool in = i < hp * 4 && yy >= 0 && yy < a.H && xx >= 0 &&
                      xx < a.W;
      const float* src =
          in ? xb + ((size_t)yy * a.W + xx) * a.Ci + c : xb;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vec == 4) {
        if (in && c < a.Ci) v = __ldg(reinterpret_cast<const float4*>(src));
      } else if (vec == 2) {
        if (in && c < a.Ci) {
          const float2 u = __ldg(reinterpret_cast<const float2*>(src));
          v.x = u.x;
          v.y = u.y;
        }
        if (in && c + 2 < a.Ci) {
          const float2 u = __ldg(reinterpret_cast<const float2*>(src + 2));
          v.z = u.x;
          v.w = u.y;
        }
      } else if (in) {
        if (c < a.Ci) v.x = __ldg(src);
        if (c + 1 < a.Ci) v.y = __ldg(src + 1);
        if (c + 2 < a.Ci) v.z = __ldg(src + 2);
        if (c + 3 < a.Ci) v.w = __ldg(src + 3);
      }
      pf[k] = v;
    }
  };
  // ... rounded to bf16 into halo buffer buf: 8-byte shared stores
  auto store_x = [&](int buf) {
    __nv_bfloat16* xd = xs + buf * hp * kXS;
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int i = tid + k * nthreads;
      if (i < hp * 4)
        *reinterpret_cast<uint2*>(xd + (i >> 2) * kXS + 4 * (i & 3)) =
            make_uint2(bf16x2(make_float2(pf[k].x, pf[k].y)),
                       bf16x2(make_float2(pf[k].z, pf[k].w)));
    }
  };
  // the 9 x CP x 16 bf16 weight slice of chunk ch into buffer buf
  auto load_w = [&](int ch, int buf) {
    const __nv_bfloat16* wsrc = a.w + (size_t)ch * 9 * CP * kKC;
    __nv_bfloat16* wd = ws + buf * 9 * CP * kKC;
    for (int i = tid; i < 9 * CP * 2; i += nthreads)   // 16-byte pieces
      cp_async16(smem_u32(wd + i * 8), wsrc + i * 8);
    asm volatile("cp.async.commit_group;\n");
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        fence_reg(acc[i][j][e]);
      }

  // lane l's ldmatrix row: pixel l % 8 + 8 (l / 8 % 2), channels 8 (l / 16)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lk = 8 * (lane >> 4);
  load_x(0);
  store_x(0);
  load_w(0, 0);
  for (int ch = 0; ch < a.nchunk; ++ch) {
    const int cur = ch & 1;
    asm volatile("cp.async.wait_group 0;\n");
    // chunk ch is in buffer cur, and every warp is done with buffer
    // cur ^ 1 (chunk ch - 1), which chunk ch + 1 now fills: its x loads
    // stay in registers while this chunk multiplies
    __syncthreads();
    const bool next = ch + 1 < a.nchunk;
    if (next) {
      load_x(ch + 1);
      load_w(ch + 1, cur ^ 1);
    }
    const uint32_t xc = smem_u32(xs + cur * hp * kXS);
    const uint32_t wc = smem_u32(ws + cur * 9 * CP * kKC);
    // per tap: this warp's A fragments (its 16 pixels of each m tile, the
    // halo shifted by the tap) by ldmatrix, then one wgmma per m tile with
    // the warpgroup's other three warps; A alternates between two register
    // sets, so one tap's loads overlap the previous tap's wgmma
    uint32_t afb[2][MT][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      uint32_t (&af)[MT][4] = afb[tap & 1];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = warp * MT + i;
        const uint32_t addr =
            xc + 2 * ((((mt >> 1) + dy) * kHW + (mt & 1) * 16 + dx + lrow) *
                          kXS + lk);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(af[i][0]), "=r"(af[i][1]), "=r"(af[i][2]), "=r"(af[i][3])
            : "r"(addr));
      }
      const uint64_t desc = b_desc(wc + (uint32_t)(tap * CP * kKC * 2));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < MT; ++i) Wgmma<CP>::run(&acc[i][0][0], af[i], desc);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (next) store_x(cur ^ 1);
  }
  __syncthreads();   // the epilogue stages over the halo and weight buffers

  // epilogue: lane (gq, tq) holds pixels gq and gq + 8 of each m tile,
  // channels 8 j + 2 tq + {0, 1}. The LayerNorm runs on those registers
  // (every lane runs the shuffles); then each warp stages its m tile in
  // shared memory, over the halo and weight buffers, and stores its 16
  // pixels, which are consecutive in NHWC, as one contiguous run of
  // 16 * Co floats: activation, residual and coalesced stores in a short
  // loop rather than unrolled per register.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_reg(acc[i][j][e]);
  constexpr int SS = CP + 8;                   // staged row stride
  float* stg = bs + CP + warp * 16 * SS;
  const float inv_co = 1.0f / (float)a.Co;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = warp * MT + i;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (a.g != nullptr) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = 8 * j + 2 * tq;
          s += (c < a.Co ? acc[i][j][2 * hh] : 0.f) +
               (c + 1 < a.Co ? acc[i][j][2 * hh + 1] : 0.f);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const float mean = s * inv_co;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = 8 * j + 2 * tq;
          const float d0 = c < a.Co ? acc[i][j][2 * hh] - mean : 0.f;
          const float d1 = c + 1 < a.Co ? acc[i][j][2 * hh + 1] - mean : 0.f;
          q += d0 * d0 + d1 * d1;
        }
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        const float inv = rsqrtf(q * inv_co + 1e-5f);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = 8 * j + 2 * tq;
          acc[i][j][2 * hh] = (acc[i][j][2 * hh] - mean) * inv * gs[c] + bs[c];
          acc[i][j][2 * hh + 1] =
              (acc[i][j][2 * hh + 1] - mean) * inv * gs[c + 1] + bs[c + 1];
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(stg + (gq + 8 * hh) * SS + 8 * j + 2 * tq) =
            make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    }
    __syncwarp();
    const int yy = y0 + (mt >> 1), xx = x0 + (mt & 1) * 16;
    const int npx = yy < a.H ? min(16, a.W - xx) : 0;
    const size_t o = (((size_t)b * a.H + yy) * a.W + xx) * a.Co;
    for (int px = 0; px < npx; ++px) {
      for (int c = lane; c < a.Co; c += 32) {
        float t = act_fn(stg[px * SS + c], a.act);
        if (a.res != nullptr) t += a.res[o + px * a.Co + c];
        a.y[o + px * a.Co + c] = t;
      }
    }
    __syncwarp();
  }
}

// bf16 copy of a weight view in the kernel's layout (nchunk, 9, co_pad,
// 16), zero past Ci and Co: element (ky, kx, ci, co) of the view is
// w[off + ky * s0 + kx * s1 + ci * s2 + co * s3] (strides may be
// negative: the backward passes the rotated, io-transposed view).
__global__ void tile_weights_kernel(const float* __restrict__ w, long long off,
                                    long long s0, long long s1, long long s2,
                                    long long s3, int Ci, int Co, int cp,
                                    int total, __nv_bfloat16* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int k = i % kKC, co = (i / kKC) % cp, tap = (i / (kKC * cp)) % 9;
    const int ci = (i / (kKC * cp * 9)) * kKC + k;
    float v = 0.f;
    if (ci < Ci && co < Co)
      v = w[off + (tap / 3) * s0 + (tap % 3) * s1 + ci * s2 + co * s3];
    // within a (chunk, tap) slice: 8 x 8 core matrices, (co / 8, k / 8)
    // at ((co / 8) * 2 + k / 8) * 64 elements, row co % 8, column k % 8
    const int slice = i - i % (kKC * cp);
    out[slice + ((co >> 3) * 2 + (k >> 3)) * 64 + (co & 7) * 8 + (k & 7)] =
        __float2bfloat16_rn(v);
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// LN parameters, then the double-buffered halo and weight slices, which
// the epilogue's per-warp staging (16 pixels x (cp + 8) floats) reuses
size_t smem_bytes(int rows, int warps, int cp) {
  const size_t loop = sizeof(__nv_bfloat16) * 2 *
                      ((rows + 2) * kHW * kXS + 9 * cp * kKC);
  const size_t stage = sizeof(float) * warps * 16 * (cp + 8);
  return sizeof(float) * 2 * cp + (loop > stage ? loop : stage);
}

template <int NT, int MT>
int set_smem_attr() {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_ln_act_kernel<NT, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

// Blocks of <NT, MT> with `warps` warps that fit on one SM (registers and
// shared memory), at least 1.
template <int NT, int MT>
int blocks_per_sm(int warps) {
  static int cache[2] = {0, 0};
  int& n = cache[warps == 8];
  if (n == 0) {
    const int rows = MT * warps / 2;
    if (set_smem_attr<NT, MT>() != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, conv3x3_ln_act_kernel<NT, MT>, 32 * warps,
            smem_bytes(rows, warps, NT * 8)) != cudaSuccess || n < 1)
      n = 1;
  }
  return n;
}

// The tile of a plane, (MT, warps): 4 rows x 32 (MT 1, 8 warps), 2 rows
// (MT 1, 4 warps) or 8 rows (MT 2, 8 warps; only while its accumulators
// fit, NT <= 20), whichever gives the least estimated time; ties go to the
// earlier. The estimate is the time of the busiest SM, which runs
// ceil(blocks / SMs) blocks, bps (blocks_per_sm) at a time, each round
// at a rate that falls below full with fewer than 8 resident warps. Per
// pixel, MT 2 costs 0.85 of MT 1 at NT >= 16 (each B slice feeds twice
// the pixels) and 1.15 of it below (fewer resident warps): factors fitted
// to device times of the three tiles on an H100. The result of a launch
// does not depend on its tile.
template <int NT>
void choose_tile(int B, int H, int W, int* mt, int* warps) {
  const long tx = (W + kTW - 1) / kTW;
  const int opts[3][2] = {{1, 8}, {1, 4}, {2, 8}};
  double best = 0.0;
  for (int k = 0; k < 3; ++k) {
    const int m = opts[k][0], wp = opts[k][1];
    int bps = 1;
    if (m == 2) {
      if constexpr (NT <= 20) bps = blocks_per_sm<NT, 2>(wp);
      else continue;
    } else {
      bps = blocks_per_sm<NT, 1>(wp);
    }
    const int rows = m * wp / 2;
    const long blocks = B * tx * ((H + rows - 1) / rows);
    const long per_sm = (blocks + num_sms() - 1) / num_sms();
    const double px = 32.0 * rows * (m == 1 ? 1.0 : (NT >= 16 ? 0.85 : 1.15));
    auto round_time = [&](long n) {          // n blocks sharing the SM
      return n * px * 8.0 / (n * wp < 8 ? n * wp : 8);
    };
    const double cost = (per_sm / bps) * round_time(bps) +
                         (per_sm % bps ? round_time(per_sm % bps) : 0.0);
    if (k == 0 || cost < best) {
      best = cost;
      *mt = m;
      *warps = wp;
    }
  }
}

template <int NT, int MT>
int launch(const Args& a, int B, int warps, cudaStream_t stream) {
  const int e = set_smem_attr<NT, MT>();
  if (e != 0) return e;
  if ((a.rows + 2) * kHW * 4 > prefetch_groups<MT>() * 32 * warps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.rows, warps, NT * 8);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + a.rows - 1) / a.rows, B);
  conv3x3_ln_act_kernel<NT, MT><<<grid, 32 * warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT>
int run(Args a, int B, cudaStream_t s) {
  int mt = 1, warps = 4;
  choose_tile<NT>(B, a.H, a.W, &mt, &warps);
  a.rows = mt * warps / 2;
  if constexpr (NT <= 20) {
    if (mt == 2) return launch<NT, 2>(a, B, warps, s);
  }
  return launch<NT, 1>(a, B, warps, s);
}

template <int NT>
int tile_code(int B, int H, int W) {
  int mt = 1, warps = 4;
  choose_tile<NT>(B, H, W, &mt, &warps);
  return mt * 100 + warps;
}

// Calls F<NT>(args...) for the n8 tile count of co_pad.
#define GW_NT_SWITCH(nt, F, ...)                 \
  switch (nt) {                                  \
    case 2: return F<2>(__VA_ARGS__);            \
    case 4: return F<4>(__VA_ARGS__);            \
    case 6: return F<6>(__VA_ARGS__);            \
    case 8: return F<8>(__VA_ARGS__);            \
    case 10: return F<10>(__VA_ARGS__);          \
    case 12: return F<12>(__VA_ARGS__);          \
    case 16: return F<16>(__VA_ARGS__);          \
    case 20: return F<20>(__VA_ARGS__);          \
    case 24: return F<24>(__VA_ARGS__);          \
    case 32: return F<32>(__VA_ARGS__);          \
    default: return -1;                          \
  }

}  // namespace

// Tiles w (see tile_weights_kernel) into out, bf16 (ceil(Ci / 16), 9,
// co_pad, 16). Returns cudaGetLastError() after the launch.
extern "C" int gw_conv3x3_tile_weights(const float* w, long long off,
                                       long long s0, long long s1,
                                       long long s2, long long s3, int Ci,
                                       int Co, int co_pad, void* out,
                                       void* stream) {
  const int total = (Ci + kKC - 1) / kKC * 9 * co_pad * kKC;
  const int blocks = (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024;
  tile_weights_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      w, off, s0, s1, s2, s3, Ci, Co, co_pad, total,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The tile a launch of this plane takes, as MT * 100 + warps (for logs),
// or -1 for an unsupported co_pad.
extern "C" int gw_conv3x3_ln_act_tile(int B, int H, int W, int co_pad) {
  GW_NT_SWITCH(co_pad / 8, tile_code, B, H, W)
}

// x (B, H, W, Ci), residual and y (B, H, W, Co): float32, contiguous; x
// 4 * vec-byte aligned with Ci % vec == 0 (vec 1, 2 or 4). wt: bf16
// (ceil(Ci / 16), 9, co_pad, 16) from gw_conv3x3_tile_weights; co_pad in
// {16, 32, 48, 64, 80, 96, 128, 160, 192, 256}. g/beta (Co,) or null (no
// LayerNorm); residual or null. Returns cudaGetLastError() after the
// launch.
extern "C" int gw_conv3x3_ln_act(const float* x, const void* wt,
                                 const float* g, const float* beta,
                                 const float* res, float* y, int B, int H,
                                 int W, int Ci, int Co, int co_pad, int act,
                                 int vec, void* stream) {
  if (Co > co_pad || co_pad % 16 != 0 || (vec != 1 && vec != 2 && vec != 4))
    return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const __nv_bfloat16*>(wt), g, beta, res, y,
               H, W, Ci, Co, act, vec, 0, (Ci + kKC - 1) / kKC};
  const int err = [&]() -> int {
    GW_NT_SWITCH(co_pad / 8, run, a, B, static_cast<cudaStream_t>(stream))
  }();
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}
