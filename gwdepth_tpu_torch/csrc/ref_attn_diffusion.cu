// K1: line-reference attention diffusion, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gwdepth_tpu/ops/pallas_kernels.py:
// ref_attn_diffusion_pallas (kernel _make_kernel, pallas_call at :112).
//
// Computes, on the attention plane a (B, P, R, H) (P = windows x tokens,
// R = reference points, H = heads as channels), three times:
//     upd = conv3x3_SAME(a, w) + bias             (H -> H channels)
//     upd = (upd - mean) / sqrt(var + 1e-5)       (mean/var over the whole
//                                                  (P, R) plane of each
//                                                  (b, head), no affine)
//     a   = a + gelu(upd)                         (exact erf GELU)
//
// Bound on the H100 (main path: B=1, P=980, R=40, H=16, float32): per call
// 3 x 2*P*R*H*H*9 = 0.54 GFLOP of float32 FMA against 5 MB of input and
// output, so the bound is the float32 CUDA-core rate (about 8 us at
// 67 TFLOP/s), not memory (about 1.5 us at 3.35 TB/s).
//
// Design. The TPU kernel kept the whole 2.5 MB plane in VMEM for all three
// steps; a Hopper block cannot hold it, and the LayerNorm statistic spans
// the whole plane, so each step needs a grid-wide reduction. Each step is
// two launches (six per call):
//   1. conv_stats: one block per tile of TP rows of P (all R, all heads).
//      The tile plus its 1-row/1-column halo and the 9*H*H weights sit in
//      shared memory (row stride H+1 words, so the 32 threads of a warp,
//      one output position each, hit 32 different banks). Each thread
//      computes all H outputs of its (p, r) position: every input value
//      loaded feeds H FMAs and every weight read is a broadcast. The block
//      writes `upd` and, for each head, its tile's (mean, M2), summed in a
//      fixed order (warp shuffles, then warps in index order).
//   2. norm_act: every block first combines all tiles' (mean, M2) for each
//      head with Chan's parallel formula, in tile order (deterministic, and
//      the variance is taken around the mean as the JAX kernel does), then
//      normalizes, applies erff GELU and adds the residual for its tile.
// The three steps ping-pong between the output and one scratch plane.
// CUDA's erff is used where the TPU kernel needed the A&S 7.1.26 rational
// approximation (Mosaic had no erf).

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums v[0..H) over the block; lane 0 of each warp parks its warp's sums in
// `red` and the first H threads add the warps up in index order.
template <int H>
__device__ __forceinline__ void block_sums(const float (&v)[H], float* red,
                                           float* out_h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 0; o < H; ++o) {
    const float s = warp_sum(v[o]);
    if (lane == 0) red[warp * H + o] = s;
  }
  __syncthreads();
  if (threadIdx.x < H) {
    float s = 0.f;
    for (int k = 0; k < nwarps; ++k) s += red[k * H + threadIdx.x];
    out_h[threadIdx.x] = s;
  }
  __syncthreads();
}

template <int H>
__global__ void conv_stats_kernel(const float* __restrict__ a,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  float* __restrict__ upd,
                                  float2* __restrict__ stats,
                                  int P, int R, int TP, int nT) {
  constexpr int HS = H + 1;
  extern __shared__ float smem[];
  __shared__ float sums[H], m2s[H];
  const int R2 = R + 2;
  float* tile = smem;                           // (TP+2) * R2 * HS
  float* ws = tile + (TP + 2) * R2 * HS;        // 9 * H * H
  float* red = ws + 9 * H * H;                  // (blockDim/32) * H

  const int t = blockIdx.x, b = blockIdx.y;
  const int p0 = t * TP;
  const int rows = min(TP, P - p0);
  const float* ab = a + (size_t)b * P * R * H;

  const int ntile = (TP + 2) * R2 * H;
  for (int i = threadIdx.x; i < ntile; i += blockDim.x) {
    const int h = i % H, rest = i / H;
    const int rr = rest % R2, pp = rest / R2;
    const int p = p0 - 1 + pp, r = rr - 1;
    float v = 0.f;
    if (p >= 0 && p < P && r >= 0 && r < R) v = ab[((size_t)p * R + r) * H + h];
    tile[(pp * R2 + rr) * HS + h] = v;
  }
  for (int i = threadIdx.x; i < 9 * H * H; i += blockDim.x) ws[i] = w[i];
  __syncthreads();

  const int pos = threadIdx.x;
  const int pl = pos / R, r = pos % R;
  const bool valid = pos < TP * R && pl < rows;
  float acc[H];
#pragma unroll
  for (int o = 0; o < H; ++o) acc[o] = valid ? bias[o] : 0.f;
  if (valid) {
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const float* src = tile + ((pl + dy) * R2 + r + dx) * HS;
        const float* wt = ws + (dy * 3 + dx) * H * H;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float v = src[i];
#pragma unroll
          for (int o = 0; o < H; ++o) acc[o] = fmaf(v, wt[i * H + o], acc[o]);
        }
      }
    }
    float* dst = upd + (((size_t)b * P + p0 + pl) * R + r) * H;
#pragma unroll
    for (int o = 0; o < H; ++o) dst[o] = acc[o];
  }

  // tile statistics per head: mean, then M2 around that mean
  const float n = (float)(rows * R);
  block_sums<H>(acc, red, sums);
  float d2[H];
#pragma unroll
  for (int o = 0; o < H; ++o) {
    const float d = valid ? acc[o] - sums[o] / n : 0.f;
    d2[o] = d * d;
  }
  block_sums<H>(d2, red, m2s);
  if (threadIdx.x < H) {
    stats[((size_t)b * nT + t) * H + threadIdx.x] =
        make_float2(sums[threadIdx.x] / n, m2s[threadIdx.x]);
  }
}

template <int H>
__global__ void norm_act_kernel(const float* __restrict__ a,
                                const float* __restrict__ upd,
                                const float2* __restrict__ stats,
                                float* __restrict__ out,
                                int P, int R, int TP, int nT) {
  __shared__ float mean_s[H], inv_s[H];
  const int t = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x < H) {
    const int h = threadIdx.x;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = 0; k < nT; ++k) {
      const float nb = (float)(min(TP, P - k * TP) * R);
      const float2 s = stats[((size_t)b * nT + k) * H + h];
      const float tot = n + nb;
      const float delta = s.x - mean;
      mean += delta * (nb / tot);
      m2 += s.y + delta * delta * (n * nb / tot);
      n = tot;
    }
    mean_s[h] = mean;
    inv_s[h] = 1.0f / sqrtf(m2 / n + 1e-5f);
  }
  __syncthreads();

  const int p0 = t * TP;
  const int rows = min(TP, P - p0);
  const size_t base = ((size_t)b * P + p0) * R * H;
  const int cnt = rows * R * H;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const int h = i % H;
    const float u = (upd[base + i] - mean_s[h]) * inv_s[h];
    const float g = 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
    out[base + i] = a[base + i] + g;
  }
}

template <int H>
int run(const float* a, float* out, float* tmp, float* upd, float2* stats,
        const float* w, const float* bias, int B, int P, int R, int TP,
        cudaStream_t stream) {
  const int nT = (P + TP - 1) / TP;
  const int threads = ((TP * R + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)(TP + 2) * (R + 2) * (H + 1) + 9 * H * H + (threads / 32) * H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_stats_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nT, B);
  const float* src = a;
  for (int step = 0; step < 3; ++step) {
    float* dst = (step == 1) ? tmp : out;
    conv_stats_kernel<H><<<grid, threads, smem, stream>>>(
        src, w, bias, upd, stats, P, R, TP, nT);
    norm_act_kernel<H><<<grid, 256, 0, stream>>>(src, upd, stats, dst, P, R,
                                                 TP, nT);
    src = dst;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a, out, tmp, upd: (B, P, R, H) float32, contiguous; stats: B * nT * H
// float2 with nT = ceil(P / TP); w: (3, 3, H, H) HWIO; bias: (H,).
// TP * R <= 1024. Returns cudaGetLastError() after the six launches.
extern "C" int gw_ref_attn_diffusion(const float* a, float* out, float* tmp,
                                     float* upd, float* stats,
                                     const float* w, const float* bias,
                                     int B, int P, int R, int H, int TP,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = reinterpret_cast<float2*>(stats);
  switch (H) {
    case 2: return run<2>(a, out, tmp, upd, st, w, bias, B, P, R, TP, s);
    case 4: return run<4>(a, out, tmp, upd, st, w, bias, B, P, R, TP, s);
    case 8: return run<8>(a, out, tmp, upd, st, w, bias, B, P, R, TP, s);
    case 16: return run<16>(a, out, tmp, upd, st, w, bias, B, P, R, TP, s);
    case 32: return run<32>(a, out, tmp, upd, st, w, bias, B, P, R, TP, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
