// Canonical Huffman lane pack: table lookup, then MSB-first bit packing
// into word-aligned lanes.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, lane_pack
// (pallas_call at line 312, bodies _lane_pack_kernel and _lane_pack_body).
//
// Contract: data (C, L) u8, lens (C,) i32, tables (C, 256) i32 holding
// code | len << 26 -> words (C, L/lane, W) u32 and bits (C, L/lane) i32.
// Lane k of chunk c packs symbols [k*lane, (k+1)*lane) that lie below
// lens[c], MSB-first from word 0; every word past the lane's last used
// one is 0, and so is column W - 1 (the TPU wrapper's bit-count column,
// which it zeroes after reading).
//
// Bound on the H100: bytes. The padded output (W words per lane, about 7x
// the payload at 2.7 bits per byte) dominates the traffic; the symbols
// are read once. Design: one thread per lane, so packing needs no carry
// between threads: a 64-bit bit buffer takes each code and emits a word
// whenever 32 bits are ready. The chunk's 256-entry table sits in shared
// memory, symbols are read 16 at a time, and the zero tails of all lanes
// are written afterwards by the whole block with coalesced stores. (The
// TPU kernel's one-hot lookups and butterfly placement exist only because
// the TPU has no gather or scatter.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct BitWriter {
  uint64_t acc = 0;
  int nbits = 0;
  int w = 0;
  int total = 0;
  uint32_t* out;
  int cap;

  __device__ __forceinline__ void put(uint32_t entry) {
    const int len = entry >> 26;
    acc = (acc << len) | (entry & ((1u << 26) - 1));
    nbits += len;
    total += len;
    if (nbits >= 32) {
      nbits -= 32;
      if (w < cap) out[w] = static_cast<uint32_t>(acc >> nbits);
      ++w;
    }
  }

  __device__ __forceinline__ void flush() {
    if (nbits > 0) {
      if (w < cap) out[w] = static_cast<uint32_t>(acc << (32 - nbits));
      ++w;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
lane_pack_kernel(const uint8_t* __restrict__ data,
                 const int* __restrict__ lens, const int* __restrict__ tables,
                 uint32_t* __restrict__ words, int* __restrict__ bits, int L,
                 int lane, int W) {
  extern __shared__ int used[];  // words written per lane
  __shared__ uint32_t tab[256];
  const int c = blockIdx.x;
  const int nl = L / lane;
  for (int s = threadIdx.x; s < 256; s += kThreads) {
    tab[s] = static_cast<uint32_t>(tables[static_cast<size_t>(c) * 256 + s]);
  }
  __syncthreads();
  const int length = min(max(lens[c], 0), L);
  for (int k = threadIdx.x; k < nl; k += kThreads) {
    const uint8_t* x = data + static_cast<size_t>(c) * L +
                       static_cast<size_t>(k) * lane;
    BitWriter bw;
    bw.out = words + (static_cast<size_t>(c) * nl + k) * W;
    bw.cap = W;
    const int ns = min(max(length - k * lane, 0), lane);
    int j = 0;
    for (; j + 16 <= ns; j += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + j);
      const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        bw.put(tab[(vs[b >> 2] >> (8 * (b & 3))) & 255]);
      }
    }
    for (; j < ns; ++j) bw.put(tab[x[j]]);
    bw.flush();
    bits[static_cast<size_t>(c) * nl + k] = bw.total;
    used[k] = min(bw.w, W - 1);
  }
  __syncthreads();
  for (int k = 0; k < nl; ++k) {
    uint32_t* o = words + (static_cast<size_t>(c) * nl + k) * W;
    for (int i = used[k] + threadIdx.x; i < W; i += kThreads) o[i] = 0;
  }
}

}  // namespace

extern "C" int lane_pack_launch(const void* data, const void* lens,
                                const void* tables, void* words, void* bits,
                                int C, int L, int lane, int W, void* stream) {
  const int nl = L / lane;
  const size_t smem = static_cast<size_t>(nl) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  lane_pack_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
      static_cast<const int*>(tables), static_cast<uint32_t*>(words),
      static_cast<int*>(bits), L, lane, W);
  return static_cast<int>(cudaGetLastError());
}
