// Canonical Huffman decode of padded lanes, for few fat lanes.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, lane_decode_lanemajor
// (pallas_call at line 673, body _lane_decode_kernel_lm).
//
// Contract (the same as lane_decode.cu): buf (C, nl, wb) u32, lane k of
// chunk c MSB-first from word 0; lens_tables (C, 256) u8 code lengths;
// lengths (C,) i32 symbols per chunk -> out (C, nl * lane) u8, where lane
// k decodes clip(lengths[c] - k*lane, 0, lane) symbols and every other
// byte is 0. A symbol's code length is the first l in 1..max_len with
// (window >> (32 - l)) < bound[l], its canonical index base[l] + that
// prefix, its symbol canon_syms[index]; when no l passes, the symbol is
// canon_syms[0] and the bit position stays. This is the geometry of a
// whole-file container: at most 112 lanes of up to 32768 symbols each.
//
// Bound on the H100: the serial chain of one lane (each symbol starts
// where the previous one ended); the bytes are a few megabytes. With so
// few lanes, one thread per lane in one block per chunk would run on a
// handful of SMs with uncoalesced word loads. Design: one block per lane,
// so every lane has an SM of its own, and the chain is cut to one
// shared-memory load per FOUR symbols. The block builds bound, base and
// canon_syms in shared memory from the code lengths, and from them a
// table of all 10-bit prefixes (length and symbol of the code that
// starts a window, 0 when it is longer than 10 bits). The lane is decoded
// in tiles of 256 words. For a tile the whole block
//   1. stages the words into shared memory with coalesced loads;
//   2. decodes the code that would start at EVERY bit position of the
//      tile (e1: length and symbol), whether or not a symbol starts there;
//   3. doubles twice: e2[p] joins e1[p] with e1[p + its length], e4[p]
//      joins e2[p] with e2[p + its length], so e4[p] holds the four
//      symbols that start at p and their total length;
// then thread 0 walks the chain through e4, four symbols a step, into a
// shared tile, and the whole block writes that tile out. The speculative
// work of steps 2 and 3 is parallel and small beside the chain it
// shortens. (The TPU kernel's register tile, bit-plane symbol lookup and
// one-hot word refill stand in for a gather it does not have.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 31;
constexpr int kLutBits = 10;
constexpr int kTileWords = 256;
constexpr int kTileBits = kTileWords * 32;  // bit positions a tile walks
// e4 of a position needs e2 up to 62 bits further on, and that e2 needs
// e1 up to 31 bits further still
constexpr int kE2Bits = kTileBits + 64;
constexpr int kE1Bits = kTileBits + 96;
constexpr int kStageWords = kE1Bits / 32 + 1;  // a window spans two words
constexpr int kOutCap = kTileBits;  // a code has at least one bit
constexpr size_t kSmemBytes = sizeof(uint64_t) * kTileBits +
                              sizeof(uint32_t) * kE2Bits +
                              sizeof(uint16_t) * kE1Bits +
                              sizeof(uint32_t) * kStageWords + kOutCap;

__global__ void __launch_bounds__(kThreads)
lane_decode_lm_kernel(const uint32_t* __restrict__ buf,
                      const uint8_t* __restrict__ lens_tables,
                      const int* __restrict__ lengths,
                      uint8_t* __restrict__ out, int nl, int wb, int lane,
                      int max_len) {
  __shared__ int s_len[256];
  __shared__ int bl_count[kMaxLen + 2];
  __shared__ int start_index[kMaxLen + 2];
  __shared__ long long bound[kMaxLen + 1];
  __shared__ long long base[kMaxLen + 1];
  __shared__ uint8_t canon[256];
  __shared__ uint16_t lut[1 << kLutBits];
  // the chain's state between tiles: the tile's first word, the bit in
  // it where the next symbol starts, symbols done, symbols of this tile
  __shared__ int s_wbase, s_bit, s_done, s_cnt;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* e4 = reinterpret_cast<uint64_t*>(smem);
  uint32_t* e2 = reinterpret_cast<uint32_t*>(e4 + kTileBits);
  uint16_t* e1 = reinterpret_cast<uint16_t*>(e2 + kE2Bits);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(e1 + kE1Bits);
  uint8_t* s_out = reinterpret_cast<uint8_t*>(s_words + kStageWords);

  const int c = blockIdx.x / nl;
  const int k = blockIdx.x - c * nl;
  const uint32_t* w = buf + (static_cast<size_t>(c) * nl + k) * wb;
  uint8_t* o = out + (static_cast<size_t>(c) * nl + k) * lane;
  const int ns = min(max(lengths[c] - k * lane, 0), lane);

  if (ns > 0) {
    // bound, base, canon_syms of this chunk's code
    if (threadIdx.x < kMaxLen + 2) bl_count[threadIdx.x] = 0;
    if (threadIdx.x == 0) s_wbase = s_bit = s_done = 0;
    __syncthreads();
    for (int s = threadIdx.x; s < 256; s += kThreads) {
      const int l = lens_tables[static_cast<size_t>(c) * 256 + s];
      const int cls = l > 0 ? min(l, kMaxLen + 1) : kMaxLen + 1;
      s_len[s] = cls;
      atomicAdd(&bl_count[cls], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      long long code = 0;
      int start = 0;
      start_index[0] = 0;
      for (int l = 1; l <= kMaxLen + 1; ++l) {
        code = (code + bl_count[l - 1]) << 1;  // first_code[l]
        start += bl_count[l - 1];              // start_index[l]
        start_index[l] = start;
        if (l <= kMaxLen) {
          bound[l] = code + bl_count[l];
          base[l] = start - code;
        }
      }
    }
    __syncthreads();
    for (int s = threadIdx.x; s < 256; s += kThreads) {
      const int cls = s_len[s];
      int rank = start_index[cls];
      for (int t = 0; t < s; ++t) rank += s_len[t] == cls;
      canon[rank] = static_cast<uint8_t>(s);
    }
    __syncthreads();
    // the same length search, run once for every 10-bit prefix
    const int lut_len = min(max_len, kLutBits);
    for (int p = threadIdx.x; p < (1 << kLutBits); p += kThreads) {
      uint32_t e = 0;
      for (int t = 1; t <= lut_len; ++t) {
        const long long v = p >> (kLutBits - t);
        if (v < bound[t]) {
          const long long idx = base[t] + v;
          e = (static_cast<uint32_t>(t) << 8) |
              canon[idx < 0 ? 0 : (idx > 255 ? 255 : idx)];
          break;
        }
      }
      lut[p] = static_cast<uint16_t>(e);
    }
    __syncthreads();

    while (true) {
      const int wbase = s_wbase;
      const int done = s_done;
      if (done >= ns) break;
      for (int i = threadIdx.x; i < kStageWords; i += kThreads) {
        const int g = wbase + i;
        s_words[i] = g < wb ? w[g] : 0u;
      }
      __syncthreads();
      // e1: the code that starts at every bit position
      for (int p = threadIdx.x; p < kE1Bits; p += kThreads) {
        const uint32_t hi =
            __funnelshift_l(s_words[(p >> 5) + 1], s_words[p >> 5], p & 31);
        uint32_t e = lut[hi >> (32 - kLutBits)];
        if (e == 0) {  // a code longer than the table's prefix, or none:
          int l = 0;   // then length 0 and canon_syms[0]
          long long idx = 0;
          for (int t = 1; t <= max_len; ++t) {
            const long long v = hi >> (32 - t);
            if (v < bound[t]) {
              l = t;
              idx = base[t] + v;
              break;
            }
          }
          e = (static_cast<uint32_t>(l) << 8) |
              canon[idx < 0 ? 0 : (idx > 255 ? 255 : idx)];
        }
        e1[p] = static_cast<uint16_t>(e);
      }
      __syncthreads();
      // e2: two symbols from p, as length << 16 | second << 8 | first
      for (int p = threadIdx.x; p < kE2Bits; p += kThreads) {
        const uint32_t a = e1[p];
        const uint32_t b = e1[p + (a >> 8)];
        e2[p] = (((a >> 8) + (b >> 8)) << 16) | ((b & 255u) << 8) | (a & 255u);
      }
      __syncthreads();
      // e4: four symbols from p, as length << 32 | the symbols, first lowest
      for (int p = threadIdx.x; p < kTileBits; p += kThreads) {
        const uint32_t a = e2[p];
        const uint32_t b = e2[p + (a >> 16)];
        e4[p] = (static_cast<uint64_t>((a >> 16) + (b >> 16)) << 32) |
                (static_cast<uint64_t>(b & 0xFFFFu) << 16) | (a & 0xFFFFu);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int p = s_bit;  // < 32
        int j = 0;
        const int jmax = min(ns - done, kOutCap);
        while (p < kTileBits && j + 4 <= jmax) {
          const uint64_t e = e4[p];
          *reinterpret_cast<uint32_t*>(s_out + j) = static_cast<uint32_t>(e);
          j += 4;
          p += static_cast<int>(e >> 32);
        }
        while (p < kTileBits && j < jmax) {
          const uint32_t e = e1[p];
          s_out[j++] = static_cast<uint8_t>(e);
          p += e >> 8;
        }
        s_cnt = j;
        s_wbase = wbase + (p >> 5);
        s_bit = p & 31;
        s_done = done + j;
      }
      __syncthreads();
      const int cnt = s_cnt;
      for (int i = threadIdx.x; i < cnt; i += kThreads) o[done + i] = s_out[i];
      __syncthreads();
    }
  }

  // zeros past the lane's symbols: bytes up to a 16-byte line, then lines
  const int z16 = min(lane, (ns + 15) & ~15);
  for (int i = ns + threadIdx.x; i < z16; i += kThreads) o[i] = 0;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = z16 + threadIdx.x * 16; i < lane; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(o + i) = zero4;
  }
}

}  // namespace

extern "C" int lane_decode_lm_launch(const void* buf, const void* lens_tables,
                                     const void* lengths, void* out, int C,
                                     int nl, int wb, int lane, int max_len,
                                     void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      lane_decode_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_decode_lm_kernel<<<C * nl, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf),
      static_cast<const uint8_t*>(lens_tables),
      static_cast<const int*>(lengths), static_cast<uint8_t*>(out), nl, wb,
      lane, max_len);
  return static_cast<int>(cudaGetLastError());
}
