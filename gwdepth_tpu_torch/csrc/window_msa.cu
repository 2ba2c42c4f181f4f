// K3: windowed multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gwdepth_tpu/ops/pallas_kernels.py:
// _window_msa_pallas (kernel body _msa_kernel, pallas_call at :232).
//
// For every window w of W = B * nW and every head h, with N tokens per
// window and head width hd:
//     s[n, m] = (q_scale * q[n]) . k[m] + bias[h, n, m] (+ mask[w mod nW, n, m])
//     out[n]  = sum_m softmax_m(s[n, :]) * v[m]
// in float32: the row maximum is subtracted before the exponential, the
// weighted sum of v is divided by the sum of the exponentials. q/k/v are
// read through element strides (b, w, h, n) with a dense last axis, so both
// the model's head-split views and the fused entry's (W, N, 3C) qkv product
// are read in place; out is (B, nW, N, H * hd), contiguous.
//
// Bound on the H100 (the window sites: N = 49, H = 16, hd 4..32): per
// (window, head) 4 N^2 hd product FLOPs against 4 N hd float32 values of q,
// k, v and out, N / 4 = 12 FLOPs per byte, below even the float32 CUDA-core
// ridge of 20: the sites are bound by their bytes. A CUDA-core kernel spends
// 60-85 % of the byte time on its FMAs alone, so the products run on the
// tensor cores here.
//
// Precision: 3xTF32. Each float32 operand x is split into big = x rounded
// to TF32 (Veltkamp's split, on the float32 pipe; p, in [0, 1], truncated)
// and small = x - big, and
// every product runs as three mma.sync.m16n8k8 TF32 passes, small * big +
// big * small + big * big, into float32 accumulators: about 22 bits of
// each product, where one TF32 pass keeps 11 and misses K3's 1e-4 bound
// once the logits reach tens. The exponentials are ex2.approx of
// s log2 e - max log2 e (one FFMA; the rounding of max log2 e scales a
// whole row and cancels in the division by its sum), the row sums float32.
// Against the plain version (float32 einsum, no TF32) the kernel reads
// max-abs 1.7e-6..3.4e-6 at the 14 window sites on an H100
// (`chip_smoke.py` phase 9, `tools/k3_ab.py`); `tests/test_torch_cuda.py`
// holds it to 1e-4 with q scaled x8 (logits about +-50) too.
//
// Design. One (window, head) pair is 4 warps, one per 16-row m-tile of the
// queries (N padded to 16 rows; a warp whose rows all lie past N idles):
//   1. q k^T: the warp holds its q rows as A fragments (scaled, split once)
//      and walks the key tiles, splitting k's B fragments as it reads them;
//      the accumulators start at bias[h] (+ mask), so the logits exist
//      once, in registers, in the mma's C layout;
//   2. the row max and sum by shuffles within the quad of lanes that holds
//      a row; the exponentials in place (the rows 8..15 of a tile past N
//      take none);
//   3. p v: the C fragments of p are A fragments of the next product once
//      the keys of each 8-tile are taken in the order 0,2,4,6,1,3,5,7 (the
//      v rows are read in that order), so p never leaves the registers;
//      the cross terms and big * big go to separate sums (and at hd <= 8
//      the even and odd key tiles too), so that chains of mmas overlap;
//   4. out / sum, stored by rows, float2 where hd is even.
// The tile sizes are template parameters (key tiles of 8: 2, 4, 7 or 8;
// hd padded to 8, 16, 24 or 32), so every shared-memory offset is known at
// compile time (runtime tile sizes and strides spent more instructions on
// addresses and bounds than on the products).
// A block owns one head h and the windows g, g + G, g + 2G, ... (block
// g * H + h of G * H: the blocks that run together read every head of the
// same windows, so the 32-byte sectors of a q/k/v row that several heads
// share are read from memory once). It stages bias[h] once (its padded
// columns -inf), and double-buffers its windows' q, k, v and mask in
// shared memory with cp.async: 16-byte copies where the rows are 16-byte
// aligned, 4-byte copies for the hd % 4 tail and for unaligned views; the
// window's mask as it lies in memory, by 16-byte copies (its rows of N = 49
// floats are not aligned). The rows and columns past N and hd are zeroed
// once and never written, so the padded products add zeros. Row strides
// are chosen so that every fragment read of q, k, v and bias is free of
// bank conflicts. The host (`launch_plan` in ops/window_msa.py) picks G so
// that the grid fits in one wave at the kernel's occupancy and every block
// owns the same number of windows to within one.
//
// Where the time goes (H100, 1/4 site (1, 1036, 16, 49, 4), 87 us against
// its 15.6 us bound): the products and their elementwise work on the
// padded 64 x 56 tiles, about 550 instructions a warp per window at about
// a third of the instruction rate; the exponentials cost nothing
// measurable, the copies about 15 % (a phase study of scratch builds with
// a phase removed, `tools/k3_ab.py`; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxHd = 32;
constexpr int kWarps = 4;  // one per 16-row m-tile of a window
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100
constexpr float kLog2e = 1.4426950408889634f;

struct Operand {
  const float* p;
  long long sb, sw, sh, sn;  // element strides of b, w, h, n; d is dense
};

// Key tiles of 8 of the instance that takes N tokens (`key_tiles` in
// ops/window_msa.py mirrors it); hd is padded to HDP = 8, 16, 24 or 32.
constexpr int key_tiles(int N) {
  return N <= 16 ? 2 : N <= 32 ? 4 : N <= 56 ? 7 : 8;
}

// The shared-memory carve-up of an instance in floats, all of it known at
// compile time (`smem_layout` in ops/window_msa.py mirrors it): bias[h]
// once, then `stages` stages of q, k, v (and the window's mask, as it lies
// in memory: N x N floats from the 16-byte boundary at or below its start).
// Keys are padded to np8 = 8 NT, query rows to np16. Strides: q, k and
// bias rows (float2 reads, 8 rows x 4 lanes) = 8 or 24 mod 32; v rows
// (scalar reads, rows 2t and 2t + 1 x 8 lanes) = 4 or 12 mod 16: every
// fragment read of a warp from them is free of bank conflicts. Every
// offset is a multiple of 4 floats, so every row of a 16-byte copy starts
// aligned.
template <int NT, int HDP>
struct Tile {
  static constexpr int KS = HDP / 8;  // k steps of q k^T = n-tiles of p v
  static constexpr int np8 = 8 * NT;
  static constexpr int np16 = 16 * ((NT + 1) / 2);
  static constexpr int bs = np8 % 16 == 8 ? np8 : np8 + 8;
  static constexpr int qs = HDP % 16 == 8 ? HDP : HDP + 8;
  static constexpr int vs = HDP + 4;
  static constexpr int q = 0;
  static constexpr int k = q + np16 * qs;
  static constexpr int v = k + np8 * qs;
  static constexpr int m = v + np8 * vs;
  static constexpr int bias = np16 * bs;
  __host__ __device__ static constexpr int stage(bool mask) {
    return m + (mask ? np16 * np8 + 8 : 0);
  }
};

__device__ __forceinline__ unsigned dynamic_smem_size() {
  unsigned r;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// big = x rounded to TF32 (11 significant bits) by Veltkamp's split on the
// float32 pipe (cvt.rna.tf32 compiles to a longer integer sequence)
__device__ __forceinline__ float big_part(float x) {
  const float t = __fmul_rn(x, 8193.f);
  return __fsub_rn(t, __fsub_rn(t, x));
}

// x = big + small, small = x - big exactly, which the mma truncates to TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  const float b = big_part(x);
  big = __float_as_uint(b);
  small = __float_as_uint(__fsub_rn(x, b));
}

// the same with big truncated to TF32 (two instructions): for p in [0, 1],
// whose small part's truncation then costs at most 2^-20 p
__device__ __forceinline__ void split_p(float x, uint32_t& big,
                                        uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b at about float32 accuracy, b split here: the two cross
// terms, then big * big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float2 b) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b.x, bb0, bs0);
  split(b.y, bb1, bs1);
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A walk over `rows` x `u` copy units dealt to the block's threads in turn:
// the first unit of this thread and the step, without a division per unit.
struct Walk {
  int r, c, dr, dc, u;
  __device__ Walk(int units) : u(units) {
    r = threadIdx.x / u;
    c = threadIdx.x - r * u;
    dr = kThreads / u;
    dc = kThreads - dr * u;
  }
  __device__ __forceinline__ void next(int& rr, int& cc) const {
    cc += dc;
    rr += dr;
    if (cc >= u) {
      cc -= u;
      ++rr;
    }
  }
};

// rows of a tile from `src` (row stride sn) into `dst` (row stride ds),
// wk.u units a row: nv 16-byte copies, then 4-byte copies
__device__ __forceinline__ void copy_rows(float* dst, int ds,
                                          const float* src, long long sn,
                                          int rows, int nv, const Walk& wk) {
  for (int r = wk.r, c = wk.c; r < rows; wk.next(r, c)) {
    const int d = c < nv ? 4 * c : 4 * nv + (c - nv);
    if (c < nv)
      cp_async16(dst + r * ds + d, src + r * sn + d);
    else
      cp_async4(dst + r * ds + d, src + r * sn + d);
  }
}

// dst[r, c] = val for rows [0, rows) and columns [c0, c1) of a tile of
// row stride ld
__device__ __forceinline__ void fill(float* dst, int ld, int rows, int c0,
                                     int c1, float val) {
  if (c1 <= c0) return;
  const Walk wk(c1 - c0);
  for (int r = wk.r, c = wk.c; r < rows; wk.next(r, c))
    dst[r * ld + c0 + c] = val;
}

// The window's mask, N x N floats from `src`, by 16-byte copies from the
// 16-byte boundary at or below src (the chunks hold only bytes of the
// mask's own allocation): src lands `mask_offset(src)` floats past dst.
__device__ __forceinline__ int mask_offset(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

__device__ __forceinline__ void copy_mask(float* dst, const float* src,
                                          int N) {
  const int off = mask_offset(src);
  for (int i = threadIdx.x; 4 * i < off + N * N; i += kThreads)
    cp_async16(dst + 4 * i, src - off + 4 * i);
}

template <int NT, int HDP>
__global__ void __launch_bounds__(kThreads)
window_msa_kernel(Operand q, Operand k, Operand v,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int W, int nW, int H, int N, int hd, int stages, int vec,
                  float q_scale) {
  using T = Tile<NT, HDP>;
  constexpr int KS = T::KS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int stage = T::stage(mask != nullptr);
  if (dynamic_smem_size() < 4u * (T::bias + stages * stage)) __trap();

  const int h = blockIdx.x % H;
  const int G = gridDim.x / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;

  // zero the stages (the padded rows and columns of q, k and v stay
  // zero: no copy writes them); then bias[h] by 4-byte copies in the first
  // window's group, its padding meanwhile: columns past N at -inf (their
  // exponentials are 0), rows past N 0
  for (int i = 4 * threadIdx.x; i < stages * stage; i += 4 * kThreads)
    *reinterpret_cast<float4*>(sm + T::bias + i) = make_float4(0, 0, 0, 0);
  __syncthreads();
  const int nv = vec ? hd >> 2 : 0;
  const Walk rows(nv + hd - 4 * nv), mrows(N);
  copy_rows(sm, T::bs, bias + (size_t)h * N * N, N, N, 0, mrows);
  fill(sm, T::bs, T::np16, N, T::bs, -INFINITY);
  fill(sm + N * T::bs, T::bs, T::np16 - N, 0, N, 0.f);
  auto fetch = [&](int w, int st) {
    const long long b = w / nW, wl = w - b * nW;
    float* s = sm + T::bias + st * stage;
    copy_rows(s + T::q, T::qs, q.p + b * q.sb + wl * q.sw + h * q.sh, q.sn,
              N, nv, rows);
    copy_rows(s + T::k, T::qs, k.p + b * k.sb + wl * k.sw + h * k.sh, k.sn,
              N, nv, rows);
    copy_rows(s + T::v, T::vs, v.p + b * v.sb + wl * v.sw + h * v.sh, v.sn,
              N, nv, rows);
    if (mask) copy_mask(s + T::m, mask + wl * N * N, N);
    cp_async_commit();
  };

  const int g0 = blockIdx.x / H;
  if (stages == 2) fetch(g0, 0);
  for (int it = 0, w = g0; w < W; ++it, w += G) {
    const int st = stages == 2 ? it & 1 : 0;
    if (stages == 1) {
      fetch(w, 0);
      cp_async_wait<0>();
    } else if (w + G < W) {
      fetch(w + G, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s = sm + T::bias + st * stage;

    if (r0 < N) {
      // q rows r0 + g and r0 + g + 8 as A fragments; the head dims of a
      // k step taken as 2t, 2t + 1 (k reads the same order)
      const float* qa = s + T::q + (r0 + g) * T::qs + 2 * t;
      uint32_t qb[KS][4], qm[KS][4];
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float2 lo = ld2(qa + 8 * j), hi = ld2(qa + 8 * T::qs + 8 * j);
        split(lo.x * q_scale, qb[j][0], qm[j][0]);
        split(hi.x * q_scale, qb[j][1], qm[j][1]);
        split(lo.y * q_scale, qb[j][2], qm[j][2]);
        split(hi.y * q_scale, qb[j][3], qm[j][3]);
      }

      // logits, starting from bias (+ mask), in the C layout: rows g and
      // g + 8, keys 8n + 2t and 8n + 2t + 1
      const float* ba = sm + (r0 + g) * T::bs + 2 * t;
      // the mask's row r0 + g (reads past N: rows never stored, or the
      // columns past N, whose -inf bias the select keeps)
      const float* ma = s + T::m +
                        mask_offset(mask + (size_t)(w % nW) * N * N) +
                        (r0 + g) * N + 2 * t;
      const float* ka = s + T::k + g * T::qs + 2 * t;
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float2 lo = ld2(ba + 8 * n), hi = ld2(ba + 8 * T::bs + 8 * n);
        if (mask) {
          const int c = 8 * n + 2 * t;
          if (n < NT - 1 || c < N) {
            lo.x += ma[8 * n];
            hi.x += ma[8 * N + 8 * n];
          }
          if (n < NT - 1 || c + 1 < N) {
            lo.y += ma[8 * n + 1];
            hi.y += ma[8 * N + 8 * n + 1];
          }
        }
        acc[n][0] = lo.x;
        acc[n][1] = lo.y;
        acc[n][2] = hi.x;
        acc[n][3] = hi.y;
#pragma unroll
        for (int j = 0; j < KS; ++j)
          mma3(acc[n], qb[j], qm[j], ld2(ka + 8 * n * T::qs + 8 * j));
      }

      // softmax numerators in place; the quad of lanes t = 0..3 holds a
      // row. exp(s - max) = 2^(s log2 e - max log2 e) by one FFMA: the
      // rounding of max log2 e scales a whole row, which the division by
      // its sum cancels
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(acc[n][0], acc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(acc[n][2], acc[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] = ex2(fmaf(acc[n][0], kLog2e, -ml0));
        acc[n][1] = ex2(fmaf(acc[n][1], kLog2e, -ml0));
        sum0 += acc[n][0] + acc[n][1];
      }
      if (r0 + 8 < N) {  // rows r0 + 8.. hold queries
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][2] = ex2(fmaf(acc[n][2], kLog2e, -ml1));
          acc[n][3] = ex2(fmaf(acc[n][3], kLog2e, -ml1));
          sum1 += acc[n][2] + acc[n][3];
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) acc[n][2] = acc[n][3] = 0.f;
      }
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);

      // p v: key tile n as A fragment, its keys in the order 2t, 2t + 1;
      // the cross terms and big * big in separate sums, and at hd <= 8 the
      // even and odd key tiles too, so that chains of mmas overlap
      constexpr int NS = KS == 1 ? 2 : 1;
      float ob[NS][KS][4], oc[NS][KS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int j = 0; j < KS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ob[i][j][e] = oc[i][j][e] = 0.f;
      const float* va = s + T::v + 2 * t * T::vs + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t pb[4], pm[4];
        split_p(acc[n][0], pb[0], pm[0]);
        split_p(acc[n][2], pb[1], pm[1]);
        split_p(acc[n][1], pb[2], pm[2]);
        split_p(acc[n][3], pb[3], pm[3]);
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const int at = 8 * n * T::vs + 8 * j;
          uint32_t vb0, vs0, vb1, vs1;
          split(va[at], vb0, vs0);
          split(va[at + T::vs], vb1, vs1);
          mma(oc[n % NS][j], pm, vb0, vb1);
          mma(oc[n % NS][j], pb, vs0, vs1);
          mma(ob[n % NS][j], pb, vb0, vb1);
        }
      }

      // out[w, r, h * hd + d] = o / sum
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
      const size_t row = (size_t)H * hd;
      float* d0 = out + ((size_t)w * N + r0 + g) * row + (size_t)h * hd;
      float* d1 = d0 + 8 * row;
      const bool st0 = r0 + g < N, st1 = r0 + g + 8 < N;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = oc[0][j][e] + ob[0][j][e];
          if (NS == 2) o[e] += oc[NS - 1][j][e] + ob[NS - 1][j][e];
        }
        const int d = 8 * j + 2 * t;
        if (d >= hd) continue;
        if ((hd & 1) == 0) {  // d + 1 < hd too
          if (st0) *reinterpret_cast<float2*>(d0 + d) =
              make_float2(o[0] * inv0, o[1] * inv0);
          if (st1) *reinterpret_cast<float2*>(d1 + d) =
              make_float2(o[2] * inv1, o[3] * inv1);
        } else {
          if (st0) d0[d] = o[0] * inv0;
          if (st1) d1[d] = o[2] * inv1;
          if (d + 1 < hd) {
            if (st0) d0[d + 1] = o[1] * inv0;
            if (st1) d1[d + 1] = o[3] * inv1;
          }
        }
      }
    }
    __syncthreads();  // the stage is read; the next fetch may refill it
  }
}

// the instances built: every key-tile count of `key_tiles` by every HDP
#define GW_K3_INSTANCES(X)                                      \
  X(2, 8) X(2, 16) X(2, 24) X(2, 32) X(4, 8) X(4, 16) X(4, 24)  \
  X(4, 32) X(7, 8) X(7, 16) X(7, 24) X(7, 32) X(8, 8) X(8, 16) \
  X(8, 24) X(8, 32)

const void* kernel_for(int nt, int hdp) {
#define GW_K3_PICK(NT, HDP) \
  if (nt == NT && hdp == HDP) return (const void*)window_msa_kernel<NT, HDP>;
  GW_K3_INSTANCES(GW_K3_PICK)
#undef GW_K3_PICK
  return nullptr;
}

}  // namespace

// Blocks of the instance for N tokens and head width hd that one SM holds
// at `smem` bytes of shared memory, on the current device, after opting
// the instance in to the whole of a block's shared memory. The wrapper
// asks once per (device, instance, smem) and plans the grid from it.
extern "C" int gw_window_msa_blocks_per_sm(int N, int hd, long long smem,
                                           int* blocks) {
  if (N < 1 || N > kMaxN || hd < 1 || hd > kMaxHd || smem <= 0 ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const void* kern = kernel_for(key_tiles(N), (hd + 7) / 8 * 8);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, kThreads, (size_t)smem);
}

// q, k, v: float32 (B, nW, H, N, hd) read through `strides`, 12 element
// strides (b, w, h, n) of q, then k, then v, each with a dense last axis;
// `vec`: every row of q, k and v starts 16-byte aligned (16-byte copies);
// bias (H, N, N) and mask (nW, N, N) or NULL, contiguous float32; out
// (B, nW, N, H * hd) contiguous float32. q is multiplied by q_scale.
// N <= 64, 1 <= hd <= 32. One launch of `grid` = G * H blocks (G <= B *
// nW) of 128 threads with `smem` bytes (at least the carve-up of `stages`
// stages: `launch_plan` in ops/window_msa.py), after
// gw_window_msa_blocks_per_sm for this N and hd on this device. Returns
// cudaGetLastError() after the launch.
extern "C" int gw_window_msa(const float* q, const float* k, const float* v,
                             const long long* strides, const float* bias,
                             const float* mask, float* out, int B, int nW,
                             int H, int N, int hd, float q_scale, int grid,
                             int stages, int vec, long long smem,
                             void* stream) {
  const long long W = (long long)B * nW;
  if (N < 1 || N > kMaxN || hd < 1 || hd > kMaxHd || H < 1 || B < 1 ||
      nW < 1 || W * N >= (1LL << 31) || grid < H || grid % H != 0 ||
      grid / H > W || (stages != 1 && stages != 2) || smem <= 0 ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const Operand oq{q, strides[0], strides[1], strides[2], strides[3]};
  const Operand ok{k, strides[4], strides[5], strides[6], strides[7]};
  const Operand ov{v, strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = key_tiles(N), hdp = (hd + 7) / 8 * 8;
#define GW_K3_RUN(NT, HDP)                                                \
  if (nt == NT && hdp == HDP)                                             \
    window_msa_kernel<NT, HDP><<<grid, kThreads, (size_t)smem, s>>>(      \
        oq, ok, ov, bias, mask, out, (int)W, nW, H, N, hd, stages, vec,   \
        q_scale);
  GW_K3_INSTANCES(GW_K3_RUN)
#undef GW_K3_RUN
  return (int)cudaGetLastError();
}
