// K2: fused 3x3 conv + channel LayerNorm + activation (+ residual), forward,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gwdepth_tpu/ops/fused_conv.py:
// conv3x3_ln_act (kernel _make_kernel, pallas_call at :378), reached through
// fused_conv_ln_act and fused_conv_ln_act_frame.
//
// Computes, on NHWC float32 x (B, H, W, Ci) with an HWIO kernel w (3, 3,
// Ci, Co), no bias, stride 1, SAME zero borders:
//     y = act(LN_c(conv3x3(x)) * g + beta) [+ residual]
// LN over the Co channels of each pixel (eps 1e-5), optional (g == null
// skips it); act 0 = none, 1 = GELU (exact, erff), 2 = ELU; residual
// optional.
//
// Operands are float32 on the CUDA cores (FMA), so the kernel agrees with
// the plain float32 version to reassociation, not to a bf16 tolerance.
//
// Bound on the H100: the main path's largest link (160 -> 160 on a
// 192 x 256 plane) is 22.6 GFLOP against 63 MB of input and output, so
// float32 arithmetic bounds it (about 340 us at 67 TFLOP/s; memory alone
// would be about 19 us at 3.35 TB/s). Every fused link of the path has at
// least 30 input channels and is arithmetic-bound the same way.
//
// Design: an implicit GEMM, M = pixels, N = Co, K = 9 * Ci.
//  - One block of 256 threads owns 64 consecutive pixels of one image row
//    and ALL Co output channels (Co <= 256; every fused link of the path
//    has Co <= 160), so the per-pixel LayerNorm finishes inside the block:
//    the 16 threads that share a pixel row are 16 lanes of one warp and
//    reduce with shuffles, in registers.
//  - Thread (tx, ty) accumulates 4 pixels (ty + 16 i) x NJ channels
//    (tx + 16 j), NJ = ceil(Co / 16) fixed at compile time.
//  - Ci is the K loop, 8 channels at a time: the block stages the
//    3 x 66 x 8 input halo and the 9 x 8 x Co weight slice in shared
//    memory. Input reads are broadcasts across the 16 channel lanes and
//    weight reads are 16 consecutive words, so no bank conflicts.
//  - Borders are masked when the halo is loaded, so a chain of links in
//    NHWC reads zero borders exactly as the TPU frame chain does after it
//    zeroes its junk columns.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTW = 64;       // pixels of one row per block
constexpr int kKC = 8;        // input channels per K step
constexpr int kThreads = 256;

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
conv3x3_ln_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ g, const float* __restrict__ beta,
                      const float* __restrict__ res, float* __restrict__ y,
                      int H, int W, int Ci, int Co, int act) {
  constexpr int CP = NJ * 16;
  constexpr int XS = 3 * (kTW + 2) * kKC;
  extern __shared__ float smem[];
  float* xs = smem;            // [3][kTW + 2][kKC]
  float* ws = smem + XS;       // [9][kKC][CP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int x0 = blockIdx.x * kTW, row = blockIdx.y, b = blockIdx.z;
  const float* xb = x + (size_t)b * H * W * Ci;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += kKC) {
    __syncthreads();   // the previous K step's reads are done
    for (int i = threadIdx.x; i < XS; i += kThreads) {
      const int k = i % kKC, rest = i / kKC;
      const int col = rest % (kTW + 2), dy = rest / (kTW + 2);
      const int yy = row + dy - 1, xx = x0 + col - 1, c = c0 + k;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < Ci)
        v = xb[((size_t)yy * W + xx) * Ci + c];
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < 9 * kKC * CP; i += kThreads) {
      const int co = i % CP, rest = i / CP;
      const int k = rest % kKC, tap = rest / kKC;
      const int c = c0 + k;
      float v = 0.f;
      if (co < Co && c < Ci) v = w[((size_t)tap * Ci + c) * Co + co];
      ws[i] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* xr = xs + ((tap / 3) * (kTW + 2) + (tap % 3)) * kKC;
      const float* wr = ws + tap * kKC * CP;
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        float av[4], bv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = xr[(ty + 16 * i) * kKC + k];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = wr[k * CP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  // epilogue: every thread runs the shuffles, stores are masked
  const float inv_co = 1.0f / (float)Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xx = x0 + ty + 16 * i;
    if (g != nullptr) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) s += (tx + 16 * j < Co) ? acc[i][j] : 0.f;
      const float mean = half_warp_sum(s) * inv_co;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float d = (tx + 16 * j < Co) ? acc[i][j] - mean : 0.f;
        q += d * d;
      }
      const float inv = 1.0f / sqrtf(half_warp_sum(q) * inv_co + 1e-5f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int co = tx + 16 * j;
        if (co < Co) acc[i][j] = (acc[i][j] - mean) * inv * g[co] + beta[co];
      }
    }
    if (xx < W) {
      const size_t o = (((size_t)b * H + row) * W + xx) * Co;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int co = tx + 16 * j;
        if (co < Co) {
          float t = acc[i][j];
          if (act == 1) t = 0.5f * t * (1.0f + erff(t * 0.70710678118654752f));
          else if (act == 2) t = t > 0.f ? t : expm1f(t);
          if (res != nullptr) t += res[o + co];
          y[o + co] = t;
        }
      }
    }
  }
}

template <int NJ>
int launch(const float* x, const float* w, const float* g, const float* beta,
           const float* res, float* y, int B, int H, int W, int Ci, int Co,
           int act, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * (kTW + 2) * kKC + 9 * kKC * NJ * 16);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_ln_act_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((W + kTW - 1) / kTW, H, B);
  conv3x3_ln_act_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      x, w, g, beta, res, y, H, W, Ci, Co, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Ci), w (3, 3, Ci, Co), residual and y (B, H, W, Co): float32,
// contiguous. g/beta (Co,) or null (no LayerNorm); residual or null.
// Co <= 256, H <= 65535. Returns cudaGetLastError() after the launch.
extern "C" int gw_conv3x3_ln_act(const float* x, const float* w,
                                 const float* g, const float* beta,
                                 const float* res, float* y, int B, int H,
                                 int W, int Ci, int Co, int act,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = (Co + 15) / 16;
#define GW_CASE(N) \
  if (nj <= N) return launch<N>(x, w, g, beta, res, y, B, H, W, Ci, Co, act, s);
  GW_CASE(1) GW_CASE(2) GW_CASE(3) GW_CASE(4) GW_CASE(5) GW_CASE(6)
  GW_CASE(8) GW_CASE(10) GW_CASE(12) GW_CASE(16)
#undef GW_CASE
  return (int)cudaErrorInvalidValue;
}
