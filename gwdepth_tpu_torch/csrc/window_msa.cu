// K3: windowed multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gwdepth_tpu/ops/pallas_kernels.py:
// _window_msa_pallas (kernel body _msa_kernel, pallas_call at :232).
//
// For every window w of W = B * nW and every head h, with N tokens per
// window and head width hd:
//     s[n, m] = (q_scale * q[n]) . k[m] + bias[h, n, m] (+ mask[w mod nW, n, m])
//     out[n]  = sum_m softmax_m(s[n, :]) * v[m]
// in float32: the row maximum is subtracted before expf, the weighted sum
// of v is divided by the sum of the exponentials. q/k/v are read through
// element strides (b, w, h, n) with a dense last axis, so both the model's
// head-split views and the fused entry's (W, N, 3C) qkv product are read
// in place; out is (B, nW, N, H * hd), contiguous.
//
// Bound on the H100 (the serving path's window sites: N = 49, H = 16,
// hd 4..32): per (window, head) 4 * N * N * hd product FLOPs against
// 4 * N * hd float32 values of q, k, v and out, so N / 4 = 12 FLOPs per
// byte whatever hd is, below the float32 CUDA-core ridge of
// 67e12 / 3.35e12 = 20: the sites are bound by the bytes.
//
// Design. The TPU kernel put windows on the 128 lanes and looped over rows
// and head dims as vector ops. Here one block owns one head and WPB
// consecutive windows, WPB = 256 / N (5 windows of 49 rows: 245 of 256
// threads busy) unless that leaves fewer than two blocks per SM, and one
// thread owns one query row:
//   1. the block stages its windows' k and v (N x HDP each, HDP = hd
//      rounded up to 4, 8, 16 or 32 and zero-padded, so every row is
//      whole float4s) and bias[h] (+ mask) rows in shared memory; a bias +
//      mask row has an odd stride, so the 32 rows a warp reads at one m
//      fall in 32 different banks; without a mask one bias copy serves
//      all windows;
//   2. each thread keeps its scaled q row in registers, computes the N
//      logits twice (once for the maximum, once for expf, the sum and the
//      weighted sum of v, all in registers; recomputing a 4..32-term dot,
//      as four independent chains, costs less than a shared-memory row of
//      logits), and writes its hd outputs.
// Every k/v read at one m is the same address for all rows of a window
// (a broadcast). Shapes outside N <= 64, hd <= 32 are refused.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxHd = 32;
constexpr int kRows = 256;    // rows (threads) a block owns at most

struct Operand {
  const float* p;
  long long sb, sw, sh, sn;   // element strides of b, w, h, n; d is dense
};

template <int HDP>
__device__ __forceinline__ float dot_row(const float (&q)[HDP],
                                         const float4* __restrict__ k) {
  // four independent partial sums: a 32-term dot is four chains of 8
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int j = 0; j < HDP / 4; ++j) {
    const float4 kk = k[j];
    s0 = fmaf(q[4 * j], kk.x, s0);
    s1 = fmaf(q[4 * j + 1], kk.y, s1);
    s2 = fmaf(q[4 * j + 2], kk.z, s2);
    s3 = fmaf(q[4 * j + 3], kk.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

template <int HDP>
__global__ void __launch_bounds__(kRows)
window_msa_kernel(Operand q, Operand k, Operand v,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int W, int nW, int H, int N, int hd, int WPB,
                  float q_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = N | 1;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * WPB;
  const int nwin = min(WPB, W - w0);
  float* ks = smem;                          // WPB * N * HDP
  float* vs = ks + WPB * N * HDP;            // WPB * N * HDP
  float* bm = vs + WPB * N * HDP;            // (mask ? WPB : 1) * N * S

  for (int wi = 0; wi < nwin; ++wi) {          // k and v, zero-padded
    const long long b = (w0 + wi) / nW, wl = (w0 + wi) % nW;
    const float* ksrc = k.p + b * k.sb + wl * k.sw + h * k.sh;
    const float* vsrc = v.p + b * v.sb + wl * v.sw + h * v.sh;
    for (int j = threadIdx.x; j < N * HDP; j += blockDim.x) {
      const int m = j / HDP, d = j % HDP;
      ks[wi * N * HDP + j] = d < hd ? ksrc[m * k.sn + d] : 0.f;
      vs[wi * N * HDP + j] = d < hd ? vsrc[m * v.sn + d] : 0.f;
    }
  }
  // bias (+ mask) rows: one warp per row, its lanes along m
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int nrows = (mask ? nwin : 1) * N;
  for (int r = threadIdx.x >> 5; r < nrows; r += nwarps) {
    const int n = r % N;
    const float* bsrc = bias + ((size_t)h * N + n) * N;
    const float* msrc =
        mask ? mask + ((size_t)((w0 + r / N) % nW) * N + n) * N : nullptr;
    for (int m = lane; m < N; m += 32)
      bm[r * S + m] = mask ? bsrc[m] + msrc[m] : bsrc[m];
  }
  __syncthreads();

  const int wi = threadIdx.x / N, n = threadIdx.x % N;
  if (wi >= nwin) return;
  const int wg = w0 + wi;
  const long long b = wg / nW, wl = wg % nW;
  const float* qp = q.p + b * q.sb + wl * q.sw + h * q.sh + n * q.sn;
  float qr[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) qr[d] = d < hd ? qp[d] * q_scale : 0.f;
  const float4* kw = reinterpret_cast<const float4*>(ks + wi * N * HDP);
  const float4* vw = reinterpret_cast<const float4*>(vs + wi * N * HDP);
  const float* brow = bm + ((mask ? wi : 0) * N + n) * S;

  float mx = -INFINITY;
  for (int m = 0; m < N; ++m)
    mx = fmaxf(mx, dot_row<HDP>(qr, kw + m * (HDP / 4)) + brow[m]);

  float acc[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) acc[d] = 0.f;
  float sum = 0.f;
  for (int m = 0; m < N; ++m) {
    const float p = expf(dot_row<HDP>(qr, kw + m * (HDP / 4)) + brow[m] - mx);
    sum += p;
#pragma unroll
    for (int j = 0; j < HDP / 4; ++j) {
      const float4 vv = vw[m * (HDP / 4) + j];
      acc[4 * j] = fmaf(p, vv.x, acc[4 * j]);
      acc[4 * j + 1] = fmaf(p, vv.y, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(p, vv.z, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(p, vv.w, acc[4 * j + 3]);
    }
  }
  const float inv = 1.0f / sum;
  float* dst = out + ((size_t)wg * N + n) * H * hd + (size_t)h * hd;
#pragma unroll
  for (int d = 0; d < HDP; ++d)
    if (d < hd) dst[d] = acc[d] * inv;
}

template <int HDP>
int run(Operand q, Operand k, Operand v, const float* bias, const float* mask,
        float* out, int W, int nW, int H, int N, int hd, float q_scale,
        cudaStream_t stream) {
  // windows per block: up to kRows rows, but no more than leaves two
  // blocks for every SM (the 1/32 sites have only 20 x 16 pairs)
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long fill = (long long)W * H / (2 * sms);
  const int WPB = (int)std::max(
      1LL, std::min<long long>(std::min(kRows / N, W), fill));
  const int threads = ((WPB * N + 31) / 32) * 32;
  const size_t smem = sizeof(float) *
      (2 * (size_t)WPB * N * HDP + (size_t)(mask ? WPB : 1) * N * (N | 1));
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(window_msa_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + WPB - 1) / WPB, H);
  window_msa_kernel<HDP><<<grid, threads, smem, stream>>>(
      q, k, v, bias, mask, out, W, nW, H, N, hd, WPB, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: float32 (B, nW, H, N, hd) read through `strides`, 12 element
// strides (b, w, h, n) of q, then k, then v, each with a dense last axis;
// bias (H, N, N) and mask (nW, N, N) or NULL, contiguous float32; out
// (B, nW, N, H * hd) contiguous float32. q is multiplied by q_scale.
// N <= 64, 1 <= hd <= 32, H <= 65535. Returns cudaGetLastError() after the
// launch.
extern "C" int gw_window_msa(const float* q, const float* k, const float* v,
                             const long long* strides, const float* bias,
                             const float* mask, float* out, int B, int nW,
                             int H, int N, int hd, float q_scale,
                             void* stream) {
  if (N < 1 || N > kMaxN || hd < 1 || hd > kMaxHd || H < 1 || H > 65535 ||
      B < 1 || nW < 1)
    return (int)cudaErrorInvalidValue;
  const Operand oq{q, strides[0], strides[1], strides[2], strides[3]};
  const Operand ok{k, strides[4], strides[5], strides[6], strides[7]};
  const Operand ov{v, strides[8], strides[9], strides[10], strides[11]};
  const int W = B * nW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 4) return run<4>(oq, ok, ov, bias, mask, out, W, nW, H, N, hd, q_scale, s);
  if (hd <= 8) return run<8>(oq, ok, ov, bias, mask, out, W, nW, H, N, hd, q_scale, s);
  if (hd <= 16) return run<16>(oq, ok, ov, bias, mask, out, W, nW, H, N, hd, q_scale, s);
  return run<32>(oq, ok, ov, bias, mask, out, W, nW, H, N, hd, q_scale, s);
}
