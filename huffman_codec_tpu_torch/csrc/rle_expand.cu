// MNP-5 expansion with the optional per-chunk diff revert.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, rle_expand
// (pallas_call at line 1031, body _rle_expand_kernel).
//
// Contract: streams (C, n) u8, is_cnt (C, n) bool from rle_classify,
// lens (C,) i32 valid stream bytes, carries (C,) u8 -> out (C, out_len)
// u8. A literal stays itself and a count byte v becomes v repeats of the
// byte before it; with use_diff the result is the running sum mod 256
// seeded by the carry. Bytes past the decoded length are 0.
//
// Bound on the H100: bytes. It reads the stream and flags once and writes
// the 64 KiB chunk once. Design: one block per chunk walks the stream in
// tiles of 4096 sources, 16 consecutive sources per thread. One block-wide
// exclusive scan of a packed pair gives each source both its output
// offset (upper 32 bits: the run lengths) and, for the diff revert, the
// sum mod 256 of everything written before it (lower 32 bits: run length
// times byte, each term mod 256); both are carried from tile to tile.
// Each source then writes its run with the reverted values computed in
// place, so the revert costs no second pass over the output.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
rle_expand_kernel(const uint8_t* __restrict__ streams,
                  const uint8_t* __restrict__ is_cnt,
                  const int* __restrict__ lens,
                  const uint8_t* __restrict__ carries,
                  uint8_t* __restrict__ out, int n, int out_len,
                  int use_diff) {
  using Scan = cub::BlockScan<long long, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  const int c = blockIdx.x;
  const uint8_t* x = streams + static_cast<size_t>(c) * n;
  const uint8_t* f = is_cnt + static_cast<size_t>(c) * n;
  uint8_t* o = out + static_cast<size_t>(c) * out_len;
  const int length = min(max(lens[c], 0), n);
  const int carry = carries[c];

  long long run = 0;  // (bytes written << 32) | sum of written bytes mod 256
  for (int t0 = 0; t0 < length; t0 += kTile) {
    const int base = t0 + threadIdx.x * kItems;
    int rep[kItems], src[kItems];
    long long v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j;
      rep[j] = 0;
      src[j] = 0;
      if (i < length) {
        const bool cnt = f[i] != 0;
        rep[j] = cnt ? x[i] : 1;
        src[j] = cnt ? (i > 0 ? x[i - 1] : 0) : x[i];
      }
      v[j] = (static_cast<long long>(rep[j]) << 32) | ((rep[j] * src[j]) & 255);
    }
    long long agg;
    Scan(scan_tmp).ExclusiveSum(v, v, agg);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (rep[j] == 0) continue;
      const long long before = run + v[j];
      const long long at = before >> 32;
      const int sum = static_cast<int>(before & 0xFFFFFFFFLL) + carry;
      for (int r = 0; r < rep[j]; ++r) {
        const long long p = at + r;
        if (p >= out_len) break;
        o[p] = static_cast<uint8_t>(use_diff ? sum + (r + 1) * src[j] : src[j]);
      }
    }
    run += agg;
  }
  const long long total = run >> 32;
  for (long long p = total + threadIdx.x; p < out_len; p += kThreads) o[p] = 0;
}

}  // namespace

extern "C" int rle_expand_launch(const void* streams, const void* is_cnt,
                                 const void* lens, const void* carries,
                                 void* out, int C, int n, int out_len,
                                 int use_diff, void* stream) {
  rle_expand_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), static_cast<const uint8_t*>(is_cnt),
      static_cast<const int*>(lens), static_cast<const uint8_t*>(carries),
      static_cast<uint8_t*>(out), n, out_len, use_diff);
  return static_cast<int>(cudaGetLastError());
}
