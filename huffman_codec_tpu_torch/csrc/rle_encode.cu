// Fused per-chunk diff + MNP-5 RLE encode.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, rle_diff_encode_fused
// (pallas_call at line 944, body _rle_fused_kernel) with tile=0.
//
// Contract: chunks (C, n) u8, lens (C,) i32 valid bytes, carries (C,) u8
// (the input byte before each chunk) -> streams (C, cap) u8, zero past each
// chunk's encoded length, and out_lens (C,) i32. Position i of the diffed
// row y emits its literal iff q < 3 and a count byte q - 2 iff q == 257 or
// it ends its segment with q >= 2, where q = (i - segment start) % 258 and
// a segment is a maximal run of equal bytes, broken before the last valid
// byte.
//
// Bound on the H100: bytes. Per 64 KiB chunk it reads the chunk once and
// writes the 88 KiB padded stream once; the work is a few dozen integer
// operations per byte. Design: one block per chunk walks the chunk in
// tiles of 4096 bytes; each thread owns 16 consecutive bytes, read with
// one 16-byte load. The segment origin is a block-wide max-scan and the
// output offset a block-wide sum-scan (CUB BlockScan), both carried from
// tile to tile; each thread then writes its literals and count bytes at
// their offsets. Tiles past the valid length are skipped, and the padded
// tail of the stream is zero-filled at the end.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kReset = 258;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

__global__ void __launch_bounds__(kThreads)
rle_encode_kernel(const uint8_t* __restrict__ chunks,
                  const int* __restrict__ lens,
                  const uint8_t* __restrict__ carries,
                  uint8_t* __restrict__ streams, int* __restrict__ out_lens,
                  int n, int cap, int use_diff) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;

  const int c = blockIdx.x;
  const uint8_t* x = chunks + static_cast<size_t>(c) * n;
  uint8_t* out = streams + static_cast<size_t>(c) * cap;
  const int length = min(max(lens[c], 0), n);
  const int carry = carries[c];

  int seg_carry = 0;  // segment origin reached before this tile
  int off_carry = 0;  // bytes emitted before this tile
  for (int t0 = 0; t0 < length; t0 += kTile) {
    const int base = t0 + threadIdx.x * kItems;
    // x[base - 2 .. base + 16]: y[j] needs x[j - 1], y[base - 1] too
    int xv[kItems + 3];
    if (base < n) {
      const uint4 w = *reinterpret_cast<const uint4*>(x + base);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < kItems; ++j) xv[j + 2] = (ws[j >> 2] >> (8 * (j & 3))) & 255;
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) xv[j + 2] = 0;
    }
    xv[0] = base >= 2 ? x[base - 2] : carry;
    xv[1] = base >= 1 ? x[base - 1] : carry;
    xv[kItems + 2] = base + kItems < n ? x[base + kItems] : 0;
    // y[k] for k = base - 1 .. base + 16 in yv[0 .. kItems + 1]
    int yv[kItems + 2];
#pragma unroll
    for (int k = 0; k < kItems + 2; ++k) {
      const int i = base - 1 + k;
      const int prev = i == 0 ? carry : xv[k];
      yv[k] = use_diff ? ((xv[k + 1] - prev) & 255) : xv[k + 1];
    }

    int seg[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j;
      const bool start = i < length &&
                         (i == 0 || yv[j + 1] != yv[j] || i == length - 1);
      seg[j] = start ? i : 0;
    }
    int seg_agg;
    Scan(scan_tmp).InclusiveScan(seg, seg, MaxOp(), seg_agg);
    __syncthreads();

    int emit[kItems];
    int qv[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j;
      const int q = (i - max(seg[j], seg_carry)) % kReset;
      // the segment ends here if the next byte starts a new one
      const bool seg_end = i == length - 1 || i + 1 == length - 1 ||
                           yv[j + 2] != yv[j + 1];
      const bool lit = i < length && q < 3;
      const bool cnt = i < length && (q == kReset - 1 || (seg_end && q >= 2));
      emit[j] = (lit ? 1 : 0) | (cnt ? 2 : 0);
      qv[j] = q;
    }
    int off[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) off[j] = (emit[j] & 1) + (emit[j] >> 1);
    int off_agg;
    Scan(scan_tmp).ExclusiveSum(off, off, off_agg);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      int o = off_carry + off[j];
      if ((emit[j] & 1) && o < cap) out[o++] = static_cast<uint8_t>(yv[j + 1]);
      if ((emit[j] & 2) && o < cap) out[o] = static_cast<uint8_t>(qv[j] - 2);
    }
    seg_carry = max(seg_carry, seg_agg);
    off_carry += off_agg;
  }
  for (int o = off_carry + threadIdx.x; o < cap; o += kThreads) out[o] = 0;
  if (threadIdx.x == 0) out_lens[c] = off_carry;
}

}  // namespace

extern "C" int rle_encode_launch(const void* chunks, const void* lens,
                                 const void* carries, void* streams,
                                 void* out_lens, int C, int n, int cap,
                                 int use_diff, void* stream) {
  rle_encode_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(carries), static_cast<uint8_t*>(streams),
      static_cast<int*>(out_lens), n, cap, use_diff);
  return static_cast<int>(cudaGetLastError());
}
