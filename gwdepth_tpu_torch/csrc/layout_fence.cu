// K4: the layout fence, an identity copy, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gwdepth_tpu/ops/pallas_kernels.py:
// layout_fence (kernel _fence_kernel, pallas_call at :264). On the TPU the
// copy pinned its operand to the default layout so that XLA could not
// carry a downstream layout into upstream ops; PyTorch has no layout
// assignment, so here it is what it computes: a copy of every byte.
//
// Bound on the H100: bytes only, the input read once and the output
// written once (13 MB in and out at the fused entry's 1/4-scale site:
// about 8 us at 3.35 TB/s).
//
// Design: a grid-stride loop over 16-byte words when both pointers are
// 16-byte aligned (torch's allocations are), then a byte loop over the
// tail; any dtype, any size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void copy_words(const uint4* __restrict__ src,
                           uint4* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

__global__ void copy_bytes(const unsigned char* __restrict__ src,
                           unsigned char* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

unsigned blocks_for(size_t n) {
  const size_t b = (n + 255) / 256;
  return (unsigned)(b < 132 * 16 ? b : 132 * 16);
}

}  // namespace

// Copies nbytes from src to dst (device pointers, not overlapping).
// Returns cudaGetLastError() after the launches.
extern "C" int gw_layout_fence(const void* src, void* dst, long long nbytes,
                               void* stream) {
  if (nbytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      (((uintptr_t)src | (uintptr_t)dst) & (uintptr_t)15) == 0;
  const size_t words = aligned ? (size_t)nbytes / 16 : 0;
  if (words)
    copy_words<<<blocks_for(words), 256, 0, s>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), words);
  const size_t done = words * 16, tail = (size_t)nbytes - done;
  if (tail)
    copy_bytes<<<blocks_for(tail), 256, 0, s>>>(
        static_cast<const unsigned char*>(src) + done,
        static_cast<unsigned char*>(dst) + done, tail);
  return (int)cudaGetLastError();
}
