// K4: the layout fence, an identity copy, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gwdepth_tpu/ops/pallas_kernels.py:
// layout_fence (kernel _fence_kernel, pallas_call at :264). On the TPU the
// copy pinned its operand to the default layout so that XLA could not
// carry a downstream layout into upstream ops; PyTorch has no layout
// assignment, so here it is what it computes: a copy of every byte into a
// contiguous tensor.
//
// Bound on the H100: bytes only, the input read once and the output
// written once (13 MB in and out at the fused entry's 1/4-scale site:
// about 8 us at 3.35 TB/s). At the small sites the launch itself (2-3 us)
// is the floor.
//
// Design: one launch per call, any byte count and alignment, and a source
// that is either contiguous or a strided view of rows: `row_bytes`
// contiguous bytes per row, the rows addressed by up to 4 dims of shape
// and byte stride (the fused entry's x is such a view: its channels are a
// slice of wider rows). dst is contiguous. The copy is split at the first
// 16-byte boundary of dst into a head (< 16 bytes), 16-byte words and a
// tail (< 16 bytes); the first threads of block 0 copy head and tail, the
// grid the words: each thread issues U = 8 independent 16-byte loads per
// trip before its 8 stores, neighbouring threads on neighbouring words; the
// grid is the resident blocks of the card (one wave) or fewer when the copy
// is smaller. (Non-temporal hints and Hopper's bulk copies through shared
// memory measured no faster on an H100: PERF.md.)
// A source word that is not 16-byte aligned (a view at an odd offset,
// rows not a multiple of 16 bytes) is gathered byte by byte; no
// main-path call does that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxDims = 4;
constexpr int kMaxDevices = 64;

// the source: nd == 0 contiguous; else rows of row_bytes contiguous bytes,
// row r at base + sum_d idx_d(r) * stride[d] over the dims' row-major index
struct Src {
  const unsigned char* base;
  long long row_bytes;
  int nd;
  long long shape[kMaxDims];
  long long stride[kMaxDims];
  unsigned words_per_row;  // row_bytes / 16 when the rows are whole words
};

struct Split {
  size_t head, words, tail;
};

__host__ __device__ inline Split split_of(const void* dst, size_t n) {
  size_t head = (16 - ((uintptr_t)dst & 15)) & 15;
  if (head > n) head = n;
  const size_t words = (n - head) / 16;
  return {head, words, n - head - words * 16};
}

// (the dims are walked with constant indices, so the struct stays in the
// kernel's parameter space rather than a local copy)
__device__ __forceinline__ long long row_offset(const Src& s,
                                                unsigned long long row) {
  long long off = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d >= s.nd) continue;
    const unsigned long long q = row / (unsigned long long)s.shape[d];
    off += (long long)(row - q * s.shape[d]) * s.stride[d];
    row = q;
  }
  return off + (long long)row * s.stride[0];
}

// the source word of dst word i of an aligned copy of whole-word rows, in
// 32-bit index arithmetic
__device__ __forceinline__ const unsigned char* src_word(const Src& s,
                                                         unsigned i) {
  unsigned row = i / s.words_per_row;
  const unsigned col = i - row * s.words_per_row;
  long long off = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d >= s.nd) continue;
    const unsigned n = (unsigned)s.shape[d], q = row / n;
    off += (long long)(row - q * n) * s.stride[d];
    row = q;
  }
  return s.base + off + (long long)row * s.stride[0] + 16 * col;
}

// the source of dst byte j (a 16-byte dst word lies in one row when rows
// are a multiple of 16 bytes and dst is aligned)
__device__ __forceinline__ const unsigned char* src_at(const Src& s,
                                                       size_t j) {
  if (s.nd == 0) return s.base + j;
  const unsigned long long row = j / (unsigned long long)s.row_bytes;
  return s.base + row_offset(s, row) + (j - row * s.row_bytes);
}

// head and tail bytes, by the first threads of block 0
__device__ __forceinline__ void copy_edges(const Src& s, unsigned char* dst,
                                           size_t n, Split sp) {
  if (blockIdx.x != 0) return;
  const unsigned t = threadIdx.x;
  if (t < sp.head) dst[t] = *src_at(s, t);
  if (t < sp.tail) dst[n - sp.tail + t] = *src_at(s, n - sp.tail + t);
}

__device__ __forceinline__ uint4 gather_word(const Src& s, size_t j) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[k] |= (uint32_t)*src_at(s, j + 4 * k + b) << (8 * b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// dst word i (16-byte aligned); its source aligned alike unless `gather`;
// ROWS: an aligned copy of whole-word rows
template <bool ROWS>
__global__ void __launch_bounds__(kThreads)
fence_vector(Src s, unsigned char* __restrict__ dst, size_t n, bool gather) {
  const Split sp = split_of(dst, n);
  copy_edges(s, dst, n, sp);
  uint4* d = reinterpret_cast<uint4*>(dst + sp.head);
  const size_t step = (size_t)gridDim.x * kThreads * kUnroll;
  for (size_t base = (size_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < sp.words; base += step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)u * kThreads;
      if (i < sp.words) {
        const size_t j = sp.head + 16 * i;
        const unsigned char* p =
            ROWS ? src_word(s, (unsigned)i) : s.base + j;
        v[u] = !ROWS && gather ? gather_word(s, j)
                               : *reinterpret_cast<const uint4*>(p);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)u * kThreads;
      if (i < sp.words) d[i] = v[u];
    }
  }
}

// resident blocks of the word copy on the whole card, per device
int resident_blocks() {
  static int cache[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  int& c = cache[dev];
  if (c == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fence_vector<false>, kThreads, 0) != cudaSuccess)
      return 0;
    c = sms * per_sm;
  }
  return c;
}

}  // namespace

// Copies the nbytes that src describes into dst (contiguous; the two do
// not overlap) in one launch. nd == 0: src is contiguous; 1 <= nd <= 4:
// src is rows of row_bytes contiguous bytes, row r at src + the byte
// offset of r's row-major index over shape[0..nd) with strides
// stride[0..nd) (nbytes = row_bytes x the rows). Returns
// cudaGetLastError() after the launch.
extern "C" int gw_layout_fence(const void* src, void* dst, long long nbytes,
                               long long row_bytes, int nd,
                               const long long* shape,
                               const long long* stride, void* stream) {
  if (nbytes <= 0) return 0;
  if (nd < 0 || nd > kMaxDims || (nd > 0 && row_bytes <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)nbytes;
  auto* d = static_cast<unsigned char*>(dst);
  Src s = {static_cast<const unsigned char*>(src), row_bytes, nd, {}, {},
           0};
  bool strides16 = true;
  for (int k = 0; k < nd; ++k) {
    s.shape[k] = shape[k];
    s.stride[k] = stride[k];
    strides16 = strides16 && stride[k] % 16 == 0;
  }
  const Split sp = split_of(dst, n);
  // every source word 16-byte aligned: contiguous and aligned like dst,
  // or aligned rows of whole words under an aligned dst
  const bool aligned =
      nd == 0 ? (((uintptr_t)src + sp.head) & 15) == 0
              : sp.head == 0 && ((uintptr_t)src & 15) == 0 &&
                    row_bytes % 16 == 0 && strides16 &&
                    sp.words <= 0xffffffffu;
  if (nd > 0 && aligned) s.words_per_row = (unsigned)(row_bytes / 16);
  // one wave of resident blocks, or fewer when the copy is smaller
  const int resident = resident_blocks();
  if (resident == 0) return (int)cudaGetLastError();
  const size_t blocks = (sp.words + (size_t)kThreads * kUnroll - 1) /
                        ((size_t)kThreads * kUnroll);
  const unsigned grid =
      (unsigned)(blocks == 0 ? 1 : blocks < (size_t)resident ? blocks
                                                              : resident);
  if (nd > 0 && aligned)
    fence_vector<true><<<grid, kThreads, 0, st>>>(s, d, n, false);
  else
    fence_vector<false><<<grid, kThreads, 0, st>>>(s, d, n, !aligned);
  return (int)cudaGetLastError();
}
