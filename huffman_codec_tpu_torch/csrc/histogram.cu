// Byte histogram of each chunk's valid prefix.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, histogram256
// (pallas_call at line 1163, body _hist_kernel).
//
// Contract: data (C, L) u8, lens (C,) i32 -> counts (C, 256) i32 of
// data[c, :lens[c]].
//
// Bound on the H100: bytes. It reads each valid byte once and writes
// 1 KiB per chunk; one shared-memory atomic per byte is far below the
// card's rate. Design: one block per chunk, 16-byte loads, and one private
// 256-bin histogram per warp in shared memory so that only the 32 lanes
// of one warp ever contend for a bin; the warp copies are summed at the
// end. Bytes past the valid length are never read. A row of any length L
// is read bytewise up to its first 16-byte aligned address, then in 16-byte
// loads, then bytewise again for the tail. (The TPU kernel's
// radix-16 outer product on the MXU exists only because the TPU has no
// fast scatter; it has no counterpart here.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ data,
                 const int* __restrict__ lens, int* __restrict__ counts,
                 int L) {
  __shared__ int hist[kWarps][256];
  for (int k = threadIdx.x; k < kWarps * 256; k += kThreads) {
    (&hist[0][0])[k] = 0;
  }
  __syncthreads();
  const int c = blockIdx.x;
  const uint8_t* x = data + static_cast<size_t>(c) * L;
  const int length = min(max(lens[c], 0), L);
  int* h = hist[threadIdx.x / 32];
  // rows start at c * L: up to 15 bytes before the first aligned line
  const int head = min(
      length,
      static_cast<int>((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15));
  if (threadIdx.x < head) atomicAdd(&h[x[threadIdx.x]], 1);
  const int n_vec = (length - head) / 16;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const uint4 w = xv[v];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      atomicAdd(&h[(ws[j >> 2] >> (8 * (j & 3))) & 255], 1);
    }
  }
  for (int i = head + n_vec * 16 + threadIdx.x; i < length; i += kThreads) {
    atomicAdd(&h[x[i]], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < 256; s += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += hist[w][s];
    counts[static_cast<size_t>(c) * 256 + s] = sum;
  }
}

}  // namespace

extern "C" int histogram_launch(const void* data, const void* lens,
                                void* counts, int C, int L, void* stream) {
  histogram_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
      static_cast<int*>(counts), L);
  return static_cast<int>(cudaGetLastError());
}
