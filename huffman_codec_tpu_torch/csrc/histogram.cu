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
// card's rate. Design: a block per slice of a row, 16-byte loads, and one
// private 256-bin histogram per warp in shared memory so that only the 32
// lanes of one warp ever contend for a bin; the warp copies are summed at
// the end. Bytes past the valid length are never read. A slice of any
// length is read bytewise up to its first 16-byte aligned address, then in
// 16-byte loads, then bytewise again for the tail. (The TPU kernel's
// radix-16 outer product on the MXU exists only because the TPU has no
// fast scatter; it has no counterpart here.)
// Slices: with many rows (the sharded step's 256) a row is one slice, and
// its block stores the row's counts. With fewer rows than the card has
// SMs (the global layout's whole-file chunk is one row) each row is cut
// into S slices at 16-byte aligned addresses, S chosen by the launcher to
// spread the rows over the card; the counts are zeroed on the
// stream first (cudaMemsetAsync) and every block adds its slice's counts
// to them with global atomics. Integer counts: the sums are exact in any
// order. Both the memset and the kernel are queued on the caller's stream
// and allocate nothing, so a CUDA graph captures them as they are.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinSlice = 16 << 10;   // bytes a slice reads at least

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ data,
                 const int* __restrict__ lens, int* __restrict__ counts,
                 int L, int span) {
  __shared__ int hist[kWarps][256];
  for (int k = threadIdx.x; k < kWarps * 256; k += kThreads) {
    (&hist[0][0])[k] = 0;
  }
  __syncthreads();
  const int c = kSplit ? blockIdx.y : blockIdx.x;
  const uint8_t* row = data + static_cast<size_t>(c) * L;
  const int length = min(max(lens[c], 0), L);
  // rows start at c * L: up to 15 bytes before the first aligned line
  const int head = min(
      length,
      static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
  int lo = 0, hi = length;
  if (kSplit) {  // slice s: [head + s * span, head + (s + 1) * span), the
                 // first slice from the row's start
    const long long s = blockIdx.x, len = length;
    lo = s == 0 ? 0 : static_cast<int>(min(len, head + s * span));
    hi = static_cast<int>(min(len, head + (s + 1) * span));
    if (lo >= hi) return;  // the whole block: nothing to count
  }
  const uint8_t* x = row + lo;
  const int n = hi - lo;
  int* h = hist[threadIdx.x / 32];
  const int lead = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15));
  if (threadIdx.x < lead) atomicAdd(&h[x[threadIdx.x]], 1);
  const int n_vec = (n - lead) / 16;
  const uint4* xv = reinterpret_cast<const uint4*>(x + lead);
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const uint4 w = xv[v];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      atomicAdd(&h[(ws[j >> 2] >> (8 * (j & 3))) & 255], 1);
    }
  }
  for (int i = lead + n_vec * 16 + threadIdx.x; i < n; i += kThreads) {
    atomicAdd(&h[x[i]], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < 256; s += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += hist[w][s];
    int* out = counts + static_cast<size_t>(c) * 256 + s;
    if (!kSplit) {
      *out = sum;
    } else if (sum) {
      atomicAdd(out, sum);
    }
  }
}

// The current device's SM count, read once a device (132 on an H100 SXM).
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0) {
    int n = 1;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = std::max(n, 1);
  }
  return sms[dev];
}

// Slices a row takes: 1 (one block a row) unless the rows are fewer than
// the card's SMs; then enough to give the card two blocks an SM, each
// reading at least kMinSlice bytes.
int slices(int C, int L) {
  if (C <= 0) return 1;
  const int sms = sm_count();
  if (C >= sms) return 1;
  const long long by_size = (static_cast<long long>(L) + kMinSlice - 1) /
                            kMinSlice;
  return static_cast<int>(
      std::max(1LL, std::min<long long>((2LL * sms + C - 1) / C, by_size)));
}

}  // namespace

extern "C" int histogram_launch(const void* data, const void* lens,
                                void* counts, int C, int L, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int S = slices(C, L);
  if (S == 1) {
    histogram_kernel<false><<<C, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
        static_cast<int*>(counts), L, L);
    return static_cast<int>(cudaGetLastError());
  }
  // spans of a 16-byte multiple, so every slice but the first starts on
  // an aligned line
  const int span = static_cast<int>(
      ((static_cast<long long>(L) + S - 1) / S + 15) / 16 * 16);
  const cudaError_t err = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(C) * 256 * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  histogram_kernel<true><<<dim3(S, C), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
      static_cast<int*>(counts), L, span);
  return static_cast<int>(cudaGetLastError());
}
