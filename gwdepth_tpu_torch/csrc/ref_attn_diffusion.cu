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
// 67 TFLOP/s), not memory (about 1.5 us at 3.35 TB/s). The products are
// float32 on the CUDA cores, as the Pallas kernel multiplies at HIGHEST.
// The class-layer planes are larger (P up to 50764, R up to 80: 56 GFLOP,
// 0.84 ms at 67 TFLOP/s, and 260 MB a plane), still bound by the FMAs.
//
// Two schedules, both one cooperative launch of a persistent grid of
// co-resident blocks (at most one per SM), each block owning a band of
// whole rows of one plane (`band_partition` / `tile_partition` in
// ops/ref_attn_diffusion.py):
//
// Band schedule (`diffusion_kernel`), for planes whose bands fit a block
// (the 1/32 layer). The TPU kernel kept the whole 2.5 MB plane in VMEM;
// here:
//   - the band, with a 1-row halo above and below and a zero column on
//     each side, and the 9*H*H weights stay in shared memory for all three
//     steps (row strides padded so that the lanes of a warp read different
//     banks);
//   - the conv: KS threads share a group of PT positions, each summing the
//     products of every KS-th input channel, so each broadcast float4 of
//     weights feeds PT positions and the groups cover the band exactly (at
//     B=1: 8 warps, 64 groups of 5 positions, KS = 4); the KS partial sums
//     are then reduced and scattered by shuffles, each thread keeping H/KS
//     output channels in registers;
//   - the block writes its (mean, M2) per head, then a grid barrier; every
//     block copies the partials of its plane into shared memory and
//     combines them in a fixed order (the mean as the count-weighted sum
//     of the block means, then M2 as the sum of each block's M2 and its
//     count x its mean's square distance from the plane's), so the
//     statistics are the same in every block and bit-equal from run to
//     run;
//   - it normalizes, applies erff GELU and adds the residual in shared
//     memory, writes the band's first and last rows to `out`, and after a
//     second grid barrier reads its neighbours' rows as the next halo.
//     Device memory sees the plane only at the first read, the halo rows
//     and the final write, each by whole rows in 16-byte words.
//
// Device-memory schedule (`diffusion_tiled_kernel`), for planes whose
// bands do not fit (the class layers: bands of 26-385 rows, up to 3 MB).
// The plane stays in device memory; each step is
//   - a conv sweep: the block walks its band in chunks of `rows_max` rows,
//     each read with its halo into shared memory (the same tile layout and
//     the same conv as the band schedule), and writes upd (conv + bias) to
//     `upd`; it combines the chunks' (mean, M2) per head in chunk order
//     (Chan's update), writes the band's (mean, M2), then a grid barrier;
//   - the plane's statistics, combined exactly as in the band schedule;
//   - a normalize sweep over the band's contiguous floats: out = x +
//     gelu((upd - mean) * inv), x being `a` at the first step and `out`
//     after it (each element read and written by one thread, in place),
//     then a grid barrier before the next conv sweep reads the halos.
// Per step it reads the plane about 2.3 times and writes it twice; all
// statistics are float32 and combined in a fixed order (no atomics), so
// reruns are bit-equal. Plane offsets are 64-bit (a 1/4 plane holds 65 M
// floats).
//
// The grid barrier is one counter in device memory that every barrier
// advances by a fixed 1024 whatever the grid (each block adds 1 without
// waiting, block 0 the rest), so it needs no reset and survives CUDA-graph
// capture and replay. The launch is cooperative, so the runtime refuses a
// grid that cannot be co-resident instead of deadlocking.
// CUDA's erff is used where the TPU kernel needed the A&S 7.1.26 rational
// approximation (Mosaic had no erf).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100
// the grid barrier's counter advances by exactly kEpisode per barrier
// (kEpisode >= any grid, a power of two, so the count stays aligned across
// launches of any grid and across wrap-around)
constexpr unsigned kEpisode = 1024;

// The (H, KS, PT) instances built, the one list of them per schedule
// (ops/ref_attn_diffusion.py reads them from here): PT * H <= 128 sums in
// registers. Band schedule: KS = 4 (and 2 for wide bands) at H = 16 and
// 32, the main path's widths; powers of two of PT for the narrow heads,
// which no main-path call takes. Device-memory schedule: one instance per
// H, the most positions a thread holds (256 threads cover 512 positions a
// chunk at H = 16).
#define GW_K1_INSTANCES(X)                                                  \
  X(2, 1, 1) X(2, 1, 2) X(2, 1, 4) X(2, 1, 8)                               \
  X(4, 1, 1) X(4, 1, 2) X(4, 1, 4) X(4, 1, 8)                               \
  X(8, 2, 1) X(8, 2, 2) X(8, 2, 4) X(8, 2, 8)                               \
  X(16, 4, 1) X(16, 4, 2) X(16, 4, 3) X(16, 4, 4) X(16, 4, 5) X(16, 4, 6)   \
  X(16, 4, 8) X(16, 2, 5) X(16, 2, 6) X(16, 2, 8)                           \
  X(32, 4, 1) X(32, 4, 2) X(32, 4, 3) X(32, 4, 4) X(32, 2, 3) X(32, 2, 4)

#define GW_K1_TILED_INSTANCES(X)                                            \
  X(2, 1, 8) X(4, 1, 8) X(8, 2, 8) X(16, 4, 8) X(32, 4, 4)

// rows [j P / nbp, (j+1) P / nbp) of a plane's block j
// (`band_partition` in ops/ref_attn_diffusion.py mirrors it; P * nbp <
// 2^31)
__device__ __forceinline__ int band_start(int j, int nbp, int P) {
  return j * P / nbp;
}

// The counter's episode when the block starts: no barrier of this launch
// can end before this block arrives, so the counter is below the end of
// the launch's first episode.
__device__ __forceinline__ unsigned episode_base(const unsigned* bar) {
  unsigned now;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(now) : "l"(bar) : "memory");
  return now - now % kEpisode;
}

__device__ __forceinline__ unsigned dynamic_smem_size() {
  unsigned r;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
}

// All blocks of the grid. Each block adds 1 to the counter without waiting
// for the result, block 0 adds kEpisode - nblocks more, and every block
// waits for the counter to reach the episode's end `end`. Nothing is reset,
// so the barrier needs no per-launch state and survives CUDA-graph replay.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned end,
                                             unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 1 + kEpisode - nblocks : 1;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                 :: "l"(bar), "r"(add) : "memory");
    unsigned now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(now) : "l"(bar) : "memory");
    } while ((int)(now - end) < 0);
  }
  __syncthreads();
}

// dst[i] = src[i] for i < n, the loads of U iterations issued before their
// stores (global src; `cg`: read around L1)
template <typename V, int U, bool cg>
__device__ __forceinline__ void batched_copy(V* dst, const V* src, int n) {
  const int T = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * T) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * T < n) v[u] = cg ? __ldcg(src + i0 + u * T)
                                    : __ldg(src + i0 + u * T);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * T < n) dst[i0 + u * T] = v[u];
  }
}

// Sums over the block's threads of each head's lane sums: thread t = l H +
// h (L = T / H lanes a head) parks v in part[t], and thread h < H adds
// its head's L lanes in order.
__device__ __forceinline__ float head_sum(float v, float* part, int H) {
  const int t = threadIdx.x, L = blockDim.x / H;
  part[t] = v;
  __syncthreads();
  float s = 0.f;
  if (t < H)
    for (int l = 0; l < L; ++l) s += part[l * H + t];
  return s;
}

__device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

template <int H>
using Vec = typename std::conditional<(H >= 4), float4, float2>::type;

// Copies nrows whole plane rows starting at `g` (contiguous, R * H floats
// each) into tile rows pp0.. of row stride HS (or back, `out`), the vector
// loads of U iterations issued before their shared-memory stores. `cg`:
// read around L1, for rows other blocks wrote in this launch.
template <int H, int HS, bool out, bool cg>
__device__ __forceinline__ void rows_io(float* tile, int pp0, float* g,
                                        int nrows, int R) {
  constexpr int V = H >= 4 ? 4 : 2, U = 8;
  const int per_row = R * H / V, n = nrows * per_row;
  const int T = blockDim.x, R2 = R + 2;
  Vec<H>* gv = reinterpret_cast<Vec<H>*>(g);
  for (int i0 = threadIdx.x; i0 < n; i0 += U * T) {
    Vec<H> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T;
      if (i >= n) break;
      const int row = i / per_row, e = (i - row * per_row) * V;
      float* c = tile + ((pp0 + row) * R2 + e / H + 1) * HS + e % H;
      if (out) {
        float* f = reinterpret_cast<float*>(&v[u]);
#pragma unroll
        for (int k = 0; k < V; ++k) f[k] = c[k];
        gv[i] = v[u];
      } else {
        v[u] = cg ? __ldcg(gv + i) : __ldg(gv + i);
      }
    }
    if (out) continue;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T;
      if (i >= n) break;
      const int row = i / per_row, e = (i - row * per_row) * V;
      float* c = tile + ((pp0 + row) * R2 + e / H + 1) * HS + e % H;
      const float* f = reinterpret_cast<const float*>(&v[u]);
#pragma unroll
      for (int k = 0; k < V; ++k) c[k] = f[k];
    }
  }
}

// Sums v[0..HK) of the lanes that share a lane mod KS over the block:
// outputs ks * HK .. of out_h[0..H). Within a warp xor shuffles over the
// lanes of one ks; lane ks parks the warp's sums in `red`; the first H
// threads add the warps up in index order.
template <int H, int KS>
__device__ __forceinline__ void block_sums(const float (&v)[H / KS],
                                           float* red, float* out_h) {
  constexpr int HK = H / KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < HK; ++j) {
    float s = v[j];
#pragma unroll
    for (int off = 16; off >= KS; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane < KS) red[warp * H + lane * HK + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < H) {
    float s = 0.f;
    for (int k = 0; k < nwarps; ++k) s += red[k * H + threadIdx.x];
    out_h[threadIdx.x] = s;
  }
  __syncthreads();
}

// One level of the reduce-scatter of the KS lanes' partial sums: of the
// first N sums a lane keeps the upper half (`upper`) or the lower, at
// [0, N / 2), and adds its partner's (lane xor m) copy of them.
template <int PT, int H, int N>
__device__ __forceinline__ void keep_half(float (&acc)[PT][H], bool upper,
                                          int m) {
#pragma unroll
  for (int k = 0; k < PT; ++k)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = upper ? acc[k][j] : acc[k][j + N / 2];
      const float keep = upper ? acc[k][j + N / 2] : acc[k][j];
      acc[k][j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
}

// The weights w (3, 3, H, H) into shared memory, rows (tap, i) padded to
// WS = H + 4, loads issued in batches.
template <int H>
__device__ __forceinline__ void load_weights(float* ws, const float* w) {
  constexpr int V = H >= 4 ? 4 : 2, WS = H + 4, per_row = H / V, U = 4;
  const int T = blockDim.x, n = 9 * H * per_row;
  const Vec<H>* wv = reinterpret_cast<const Vec<H>*>(w);
  for (int i0 = threadIdx.x; i0 < n; i0 += U * T) {
    Vec<H> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * T < n) v[u] = __ldg(wv + i0 + u * T);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T;
      if (i < n)
        *reinterpret_cast<Vec<H>*>(ws + (i / per_row) * WS +
                                   (i % per_row) * V) = v[u];
    }
  }
}

// The 3x3 conv of this thread's PT positions (`base`: tile offset of each
// 3x3 window's top-left) over its input channels ks, ks + KS, ... from
// shared memory; the KS lanes' partial sums are then reduced and
// scattered (at each xor distance a lane keeps half of its outputs and
// adds its partner's copy of them), so acc[k][0..H/KS) end as outputs
// ks * H/KS .. of position k, plus the bias.
template <int H, int PT, int KS>
__device__ __forceinline__ void conv_positions(
    float (&acc)[PT][H], const float* tile, const float* ws,
    const int (&base)[PT], int ks, int R2, const float (&bias_k)[H / KS]) {
  constexpr int HS = H + KS, WS = H + 4, HK = H / KS;
#pragma unroll
  for (int k = 0; k < PT; ++k)
#pragma unroll
    for (int o = 0; o < H; ++o) acc[k][o] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const float* src = tile + ((tap / 3) * R2 + tap % 3) * HS + ks;
    const float* wt = ws + (tap * H + ks) * WS;
#pragma unroll
    for (int ii = 0; ii < HK; ++ii) {
      float v[PT];
#pragma unroll
      for (int k = 0; k < PT; ++k) v[k] = src[base[k] + ii * KS];
      float wr[H];
      if constexpr (H % 4 == 0) {
#pragma unroll
        for (int o = 0; o < H; o += 4) {
          const float4 q =
              *reinterpret_cast<const float4*>(wt + ii * KS * WS + o);
          wr[o] = q.x; wr[o + 1] = q.y; wr[o + 2] = q.z; wr[o + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int o = 0; o < H; ++o) wr[o] = wt[ii * KS * WS + o];
      }
#pragma unroll
      for (int k = 0; k < PT; ++k)
#pragma unroll
        for (int o = 0; o < H; ++o) acc[k][o] = fmaf(v[k], wr[o], acc[k][o]);
    }
  }
  if constexpr (KS == 4) {
    keep_half<PT, H, H>(acc, ks & 2, 2);
    keep_half<PT, H, H / 2>(acc, ks & 1, 1);
  } else if constexpr (KS == 2) {
    keep_half<PT, H, H>(acc, ks & 1, 1);
  }
#pragma unroll
  for (int k = 0; k < PT; ++k)
#pragma unroll
    for (int j = 0; j < HK; ++j) acc[k][j] += bias_k[j];
}

// This thread's positions q = g + k NG of a block of npos positions, rows
// of R: tile offsets of their 3x3 windows and whether they exist.
template <int PT, int HS>
__device__ __forceinline__ void positions(int (&base)[PT], bool (&valid)[PT],
                                          int g, int NG, int npos, int R) {
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int q = g + k * NG;
    valid[k] = q < npos;
    const int qq = valid[k] ? q : 0;
    base[k] = ((qq / R) * (R + 2) + qq % R) * HS;
  }
}

// The block's mean of its valid outputs per head, in sums (times npos, the
// sum), and M2 around it, in m2s: s holds this thread's HK sums.
template <int H, int PT, int KS>
__device__ __forceinline__ void block_moments(const float (&acc)[PT][H],
                                              const bool (&valid)[PT],
                                              int ks, float inv_n,
                                              float* red, float* sums,
                                              float* m2s) {
  constexpr int HK = H / KS;
  float s[HK];
#pragma unroll
  for (int j = 0; j < HK; ++j) {
    s[j] = 0.f;
#pragma unroll
    for (int k = 0; k < PT; ++k) s[j] += valid[k] ? acc[k][j] : 0.f;
  }
  block_sums<H, KS>(s, red, sums);
#pragma unroll
  for (int j = 0; j < HK; ++j) {
    const float m = sums[ks * HK + j] * inv_n;
    s[j] = 0.f;
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const float d = valid[k] ? acc[k][j] - m : 0.f;
      s[j] = fmaf(d, d, s[j]);
    }
  }
  block_sums<H, KS>(s, red, m2s);
}

// The plane's statistics from its nbp blocks' (mean, M2) `st` and row
// counts x R `cnt`, the same fixed order in every block: the mean as the
// count-weighted sum of the block means, then M2 as the sum of each
// block's M2 and its count x (block mean - mean)^2; each head's L lanes
// (threads h, h + H, ...) take every L-th block, then the lanes are added
// in order. Leaves the mean in mean_s and 1 / sqrt(var + 1e-5) in inv_s.
__device__ __forceinline__ void plane_stats(const float2* st, float2* pst,
                                            const float* cnt, float* part,
                                            float* mean_s, float* inv_s,
                                            int nbp, int H, float n_plane) {
  const int t = threadIdx.x, L = blockDim.x / H, h_c = t % H, l_c = t / H;
  batched_copy<float2, 8, true>(pst, st, nbp * H);
  __syncthreads();
  float acc_s = 0.f;
#pragma unroll 4
  for (int j = l_c; j < nbp; j += L)
    acc_s = fmaf(cnt[j], pst[j * H + h_c].x, acc_s);
  const float tot = head_sum(acc_s, part, H);
  if (t < H) mean_s[t] = tot / n_plane;
  __syncthreads();
  const float m = mean_s[h_c];
  acc_s = 0.f;
#pragma unroll 4
  for (int j = l_c; j < nbp; j += L) {
    const float2 s = pst[j * H + h_c];
    const float d = s.x - m;
    acc_s += fmaf(cnt[j] * d, d, s.y);
  }
  const float m2 = head_sum(acc_s, part, H);
  if (t < H) inv_s[t] = 1.0f / sqrtf(m2 / n_plane + 1e-5f);
  __syncthreads();
}

// The shared-memory carve-up of both schedules (`band_partition`'s and
// `tile_partition`'s sum of bytes): weights, block partials, block counts,
// tile of rows_max rows with halo, warp sums, lane sums, four vectors of H.
struct Smem {
  float *ws, *cnt, *tile, *red, *part, *sums, *m2s, *mean_s, *inv_s;
  float2* pst;
};

template <int H, int KS>
__device__ __forceinline__ Smem carve(float* smem, int nbp, int rows_max,
                                      int R) {
  constexpr int HS = H + KS, WS = H + 4;
  Smem s;
  s.ws = smem;                                            // 9 * H * WS
  s.pst = reinterpret_cast<float2*>(s.ws + 9 * H * WS);   // nbp * H
  s.cnt = reinterpret_cast<float*>(s.pst + nbp * H);      // nbp
  s.tile = s.cnt + nbp;                        // (rows_max + 2) * R2 * HS
  s.red = s.tile + (rows_max + 2) * (R + 2) * HS;         // (T / 32) * H
  s.part = s.red + (blockDim.x / 32) * H;                 // T
  s.sums = s.part + blockDim.x;                           // H
  s.m2s = s.sums + H;                                     // H
  s.mean_s = s.m2s + H;                                   // H
  s.inv_s = s.mean_s + H;                                 // H
  if ((size_t)(reinterpret_cast<char*>(s.inv_s + H) -
               reinterpret_cast<char*>(smem)) > dynamic_smem_size())
    __trap();
  return s;
}

// Each block: a band of whole rows of one plane, with KS threads on each
// group of PT positions (positions g, g + T/KS, ...; thread t is lane
// t mod KS of group t / KS), each thread summing the products of the input
// channels i = ks, ks + KS, ...; the groups' partial sums are then reduced
// and scattered so that each thread keeps H / KS output channels.
template <int H, int PT, int KS>
__global__ void __launch_bounds__(kMaxThreads)
diffusion_kernel(const float* __restrict__ a, float* __restrict__ out,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float2* __restrict__ stats, unsigned* __restrict__ bar,
                 int P, int R, int nbp, int rows_max) {
  // tile row stride H + KS and weight row stride H + 4: the KS lanes of a
  // group and the groups of a warp read different banks
  constexpr int HS = H + KS, HK = H / KS;
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int R2 = R + 2;
  const Smem sm = carve<H, KS>(smem, nbp, rows_max, R);
  float* tile = sm.tile;

  unsigned episode = episode_base(bar);
  const int b = blockIdx.x / nbp, jb = blockIdx.x % nbp;
  const int p0 = band_start(jb, nbp, P);
  const int rows = band_start(jb + 1, nbp, P) - p0;
  const size_t plane = (size_t)P * R * H;
  const float* ab = a + b * plane;
  float* ob = out + b * plane;
  const bool up = p0 > 0, down = p0 + rows < P;

  load_weights<H>(sm.ws, w);
  // zeros around the band (side columns, rows outside the plane), then
  // the band and its halo rows
  for (int i = t; i < (rows + 2) * R2 * HS; i += T) tile[i] = 0.f;
  for (int j = t; j < nbp; j += T)
    sm.cnt[j] =
        (float)((band_start(j + 1, nbp, P) - band_start(j, nbp, P)) * R);
  __syncthreads();
  rows_io<H, HS, false, false>(
      tile, up ? 0 : 1, const_cast<float*>(ab) + (size_t)(p0 - up) * R * H,
      rows + up + down, R);
  __syncthreads();

  // this thread's positions q = g + k NG of the band's rows * R, its input
  // channels ks, ks + KS, ... and, after the reduction, its outputs
  // ks * HK ..
  const int ks = t % KS, g = t / KS, NG = T / KS;
  const int npos = rows * R;
  int base[PT];
  bool valid[PT];
  positions<PT, HS>(base, valid, g, NG, npos, R);
  const float inv_blk = 1.0f / (float)npos;
  const float n_plane = (float)P * R;
  float bias_k[HK];
#pragma unroll
  for (int j = 0; j < HK; ++j) bias_k[j] = bias[ks * HK + j];

  float acc[PT][H];
  for (int step = 0; step < 3; ++step) {
    conv_positions<H, PT, KS>(acc, tile, sm.ws, base, ks, R2, bias_k);
    // the band's mean, then M2 around it, per head
    block_moments<H, PT, KS>(acc, valid, ks, inv_blk, sm.red, sm.sums,
                             sm.m2s);
    if (t < H)
      stats[(size_t)blockIdx.x * H + t] =
          make_float2(sm.sums[t] * inv_blk, sm.m2s[t]);
    grid_barrier(bar, episode += kEpisode, gridDim.x);
    plane_stats(stats + (size_t)(b * nbp) * H, sm.pst, sm.cnt, sm.part,
                sm.mean_s, sm.inv_s, nbp, H, n_plane);

    // normalize, GELU, residual on this thread's outputs of its positions;
    // each value is read and written by its own thread only (every
    // thread's conv ended before the barrier). The statistics and old
    // values are read into registers first and the new values stored
    // after, so no shared-memory store orders the loads behind it.
    {
      float mu[HK], iv[HK];
#pragma unroll
      for (int j = 0; j < HK; ++j) {
        mu[j] = sm.mean_s[ks * HK + j];
        iv[j] = sm.inv_s[ks * HK + j];
      }
#pragma unroll
      for (int k = 0; k < PT; ++k) {
        const float* c = tile + base[k] + (R2 + 1) * HS + ks * HK;
#pragma unroll
        for (int j = 0; j < HK; ++j)
          acc[k][j] = c[j] + gelu((acc[k][j] - mu[j]) * iv[j]);
      }
#pragma unroll
      for (int k = 0; k < PT; ++k) {
        if (!valid[k]) continue;
        float* c = tile + base[k] + (R2 + 1) * HS + ks * HK;
#pragma unroll
        for (int j = 0; j < HK; ++j) c[j] = acc[k][j];
      }
    }
    __syncthreads();
    if (step == 2) break;

    // publish the band's edge rows, then take the neighbours' as the halo
    if (up)
      rows_io<H, HS, true, false>(tile, 1, ob + (size_t)p0 * R * H, 1, R);
    if (down)
      rows_io<H, HS, true, false>(tile, rows,
                                  ob + (size_t)(p0 + rows - 1) * R * H, 1, R);
    grid_barrier(bar, episode += kEpisode, gridDim.x);
    if (up)
      rows_io<H, HS, false, true>(tile, 0, ob + (size_t)(p0 - 1) * R * H, 1,
                                  R);
    if (down)
      rows_io<H, HS, false, true>(tile, rows + 1,
                                  ob + (size_t)(p0 + rows) * R * H, 1, R);
    __syncthreads();
  }

  rows_io<H, HS, true, false>(tile, 1, ob + (size_t)p0 * R * H, rows, R);
}

// The device-memory schedule: each block's band of whole rows of one plane
// stays in device memory (`out`, and `upd` for the conv's output) and is
// swept in chunks of at most rows_max rows, each chunk with its halo in
// shared memory and its positions spread over the threads as in
// `diffusion_kernel`.
template <int H, int PT, int KS>
__global__ void __launch_bounds__(kMaxThreads)
diffusion_tiled_kernel(const float* __restrict__ a, float* __restrict__ out,
                       float* __restrict__ upd, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float2* __restrict__ stats, unsigned* __restrict__ bar,
                       int P, int R, int nbp, int rows_max) {
  constexpr int HS = H + KS, HK = H / KS, V = H >= 4 ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int R2 = R + 2;
  const Smem sm = carve<H, KS>(smem, nbp, rows_max, R);
  float* tile = sm.tile;

  unsigned episode = episode_base(bar);
  const int b = blockIdx.x / nbp, jb = blockIdx.x % nbp;
  const int p0 = band_start(jb, nbp, P);
  const int rows = band_start(jb + 1, nbp, P) - p0;
  const size_t plane = (size_t)P * R * H, row = (size_t)R * H;
  const float* ab = a + b * plane;
  float* ob = out + b * plane;
  float* ub = upd + b * plane;

  load_weights<H>(sm.ws, w);
  // the side columns stay zero; rows outside the plane are zeroed per chunk
  for (int i = t; i < (rows_max + 2) * R2 * HS; i += T) tile[i] = 0.f;
  for (int j = t; j < nbp; j += T)
    sm.cnt[j] =
        (float)((band_start(j + 1, nbp, P) - band_start(j, nbp, P)) * R);
  __syncthreads();

  const int ks = t % KS, g = t / KS, NG = T / KS;
  const float n_plane = (float)P * R;
  float bias_k[HK];
#pragma unroll
  for (int j = 0; j < HK; ++j) bias_k[j] = bias[ks * HK + j];

  float acc[PT][H];
  for (int step = 0; step < 3; ++step) {
    // the plane as the conv reads it: `a` at the first step (read-only),
    // then `out`, which other blocks wrote in this launch (read around L1)
    const float* xb = step == 0 ? ab : ob;
    // the band's running count, mean and M2 per head (threads t < H)
    float run_n = 0.f, run_mean = 0.f, run_m2 = 0.f;
    for (int c0 = p0; c0 < p0 + rows; c0 += rows_max) {
      const int cr = min(rows_max, p0 + rows - c0);
      const int lo = max(c0 - 1, 0), hi = min(c0 + cr + 1, P);
      // every thread's reads of the last chunk's tile ended in
      // block_moments' barriers
      if (c0 == 0)
        for (int i = t; i < R2 * HS; i += T) tile[i] = 0.f;
      if (c0 + cr == P)
        for (int i = t; i < R2 * HS; i += T) tile[(cr + 1) * R2 * HS + i] = 0.f;
      if (step == 0)
        rows_io<H, HS, false, false>(tile, lo - c0 + 1,
                                     const_cast<float*>(xb) + lo * row,
                                     hi - lo, R);
      else
        rows_io<H, HS, false, true>(tile, lo - c0 + 1,
                                    const_cast<float*>(xb) + lo * row,
                                    hi - lo, R);
      __syncthreads();

      const int npos = cr * R;
      int base[PT];
      bool valid[PT];
      positions<PT, HS>(base, valid, g, NG, npos, R);
      conv_positions<H, PT, KS>(acc, tile, sm.ws, base, ks, R2, bias_k);
      float* uc = ub + (size_t)c0 * row + ks * HK;
#pragma unroll
      for (int k = 0; k < PT; ++k) {
        if (!valid[k]) continue;
        float* u = uc + (size_t)(g + k * NG) * H;
        if constexpr (HK % 4 == 0) {
#pragma unroll
          for (int j = 0; j < HK; j += 4)
            *reinterpret_cast<float4*>(u + j) = make_float4(
                acc[k][j], acc[k][j + 1], acc[k][j + 2], acc[k][j + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < HK; ++j) u[j] = acc[k][j];
        }
      }
      const float inv_n = 1.0f / (float)npos;
      block_moments<H, PT, KS>(acc, valid, ks, inv_n, sm.red, sm.sums,
                               sm.m2s);
      if (t < H) {
        // Chan's update of the band's moments by the chunk's
        const float n_c = (float)npos, m_c = sm.sums[t] * inv_n;
        const float n_new = run_n + n_c, d = m_c - run_mean;
        run_mean += d * (n_c / n_new);
        run_m2 += sm.m2s[t] + d * d * (run_n * n_c / n_new);
        run_n = n_new;
      }
    }
    if (t < H)
      stats[(size_t)blockIdx.x * H + t] = make_float2(run_mean, run_m2);
    grid_barrier(bar, episode += kEpisode, gridDim.x);
    plane_stats(stats + (size_t)(b * nbp) * H, sm.pst, sm.cnt, sm.part,
                sm.mean_s, sm.inv_s, nbp, H, n_plane);

    // normalize, GELU, residual over the band's floats, in place in `out`
    {
      const size_t off = (size_t)p0 * row;
      const int n = rows * R * (H / V);
      const Vec<H>* xs = reinterpret_cast<const Vec<H>*>(xb + off);
      const Vec<H>* us = reinterpret_cast<const Vec<H>*>(ub + off);
      Vec<H>* os = reinterpret_cast<Vec<H>*>(ob + off);
      for (int i = t; i < n; i += T) {
        Vec<H> xv = step == 0 ? __ldg(xs + i) : __ldcg(xs + i);
        const Vec<H> uv = __ldcg(us + i);
        float* xf = reinterpret_cast<float*>(&xv);
        const float* uf = reinterpret_cast<const float*>(&uv);
        const int h0 = (i * V) % H;
#pragma unroll
        for (int k = 0; k < V; ++k)
          xf[k] += gelu((uf[k] - sm.mean_s[h0 + k]) * sm.inv_s[h0 + k]);
        os[i] = xv;
      }
    }
    if (step < 2) grid_barrier(bar, episode += kEpisode, gridDim.x);
  }
}

// Blocks of `kern` (threads, smem) that the whole card holds at once, with
// the kernel's dynamic shared-memory limit raised to the most a block may
// use; cached per (device, kernel, threads, smem), as the host path runs
// on every call.
int resident_blocks(const void* kern, int threads, size_t smem, int* out) {
  struct Entry {
    const void* kern;
    int dev, threads;
    size_t smem;
    int blocks;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < used; ++i)
    if (cache[i].kern == kern && cache[i].dev == dev &&
        cache[i].threads == threads && cache[i].smem == smem) {
      *out = cache[i].blocks;
      return 0;
    }
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  *out = sms * per_sm;
  if (used < 64) cache[used++] = {kern, dev, threads, smem, *out};
  return 0;
}

// One cooperative launch of `kern` on `grid` blocks, every one of which
// must be resident at once: the grid barrier waits for all.
template <typename... KArgs, typename... Args>
int launch_cooperative(void (*kern)(KArgs...), int grid, int threads,
                       size_t smem, cudaStream_t stream, Args... args) {
  int resident = 0;
  cudaError_t e = (cudaError_t)resident_blocks((const void*)kern, threads,
                                               smem, &resident);
  if (e != cudaSuccess) return (int)e;
  if (grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// a, out: (B, P, R, H) float32, contiguous, not overlapping; w: (3, 3, H, H)
// HWIO; bias: (H,); stats: B * nbp * H float2 of scratch; bar: the grid
// barrier's counter, one unsigned word of device memory, zero before its
// first call, that no launch running at the same time uses. One
// cooperative launch of B * nbp <= 1024 blocks of `threads` threads (a
// multiple of 32, at most 256) and smem bytes of shared memory (at least
// the kernel's carve-up: `band_partition` / `tile_partition` in
// ops/ref_attn_diffusion.py), KS threads on each group of PT positions.
// upd == NULL: the band schedule, each block owning at most rows_max rows
// ((threads / KS) * PT >= rows_max * R; (H, KS, PT) one of
// GW_K1_INSTANCES). Otherwise the device-memory schedule, upd being
// (B, P, R, H) float32 of scratch, each block sweeping its band in chunks
// of at most rows_max rows ((threads / KS) * PT >= rows_max * R; (H, KS,
// PT) one of GW_K1_TILED_INSTANCES). Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int gw_ref_attn_diffusion(const float* a, float* out, float* upd,
                                     float* stats, unsigned* bar,
                                     const float* w, const float* bias,
                                     int B, int P, int R, int H, int nbp,
                                     int rows_max, int threads, int KS,
                                     int PT, long long smem, void* stream) {
  if (threads % 32 != 0 || threads > kMaxThreads || KS < 1 ||
      rows_max < 1 || threads / KS * PT < rows_max * R ||
      B * nbp > (int)kEpisode || (long long)P * (nbp + 1) >= (1LL << 31) ||
      smem <= 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = reinterpret_cast<float2*>(stats);
  const int grid = B * nbp;
  const size_t sb = (size_t)smem;
  if (upd == nullptr) {
#define GW_K1_RUN(h, ks, pt)                                                \
    if (H == h && KS == ks && PT == pt)                                     \
      return launch_cooperative(diffusion_kernel<h, pt, ks>, grid, threads, \
                                sb, s, a, out, w, bias, st, bar, P, R, nbp, \
                                rows_max);
    GW_K1_INSTANCES(GW_K1_RUN)
#undef GW_K1_RUN
  } else {
#define GW_K1_RUN(h, ks, pt)                                                \
    if (H == h && KS == ks && PT == pt)                                     \
      return launch_cooperative(diffusion_tiled_kernel<h, pt, ks>, grid,    \
                                threads, sb, s, a, out, upd, w, bias, st,   \
                                bar, P, R, nbp, rows_max);
    GW_K1_TILED_INSTANCES(GW_K1_RUN)
#undef GW_K1_RUN
  }
  return (int)cudaErrorInvalidValue;
}
