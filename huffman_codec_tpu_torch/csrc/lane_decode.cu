// Canonical Huffman decode of padded lanes.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, lane_decode
// (pallas_call at line 531, body _lane_decode_kernel).
//
// Contract: buf (C, nl, wb) u32, lane k of chunk c MSB-first from word 0;
// lens_tables (C, 256) u8 code lengths; lengths (C,) i32 symbols per chunk
// -> out (C, nl * lane) u8, where lane k decodes
// clip(lengths[c] - k*lane, 0, lane) symbols and every other byte is 0.
// A symbol's code length is the first l in 1..max_len with
// (window >> (32 - l)) < bound[l], its canonical index base[l] + that
// prefix, its symbol canon_syms[index]; canonical order is ascending
// (length, symbol) and first_code[l] = (first_code[l-1] + count[l-1]) << 1.
//
// Bound on the H100: the serial chain of each lane. Bytes are small (it
// reads the packed lanes and writes the symbols once), but each symbol
// depends on the bit position the previous one left. Design: one thread
// per lane, so lanes never wait on each other; the block (one chunk)
// first builds bound, base and canon_syms in shared memory from the code
// lengths, then each thread keeps a left-justified 64-bit window that it
// refills one word at a time, and stores its symbols four at a time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 31;

__global__ void __launch_bounds__(kThreads)
lane_decode_kernel(const uint32_t* __restrict__ buf,
                   const uint8_t* __restrict__ lens_tables,
                   const int* __restrict__ lengths, uint8_t* __restrict__ out,
                   int nl, int wb, int lane, int max_len) {
  __shared__ int s_len[256];
  __shared__ int bl_count[kMaxLen + 2];
  __shared__ int start_index[kMaxLen + 2];
  __shared__ long long bound[kMaxLen + 1];
  __shared__ long long base[kMaxLen + 1];
  __shared__ uint8_t canon[256];
  const int c = blockIdx.x;

  if (threadIdx.x < kMaxLen + 2) bl_count[threadIdx.x] = 0;
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

  const int length = lengths[c];
  for (int k = threadIdx.x; k < nl; k += kThreads) {
    const uint32_t* w = buf + (static_cast<size_t>(c) * nl + k) * wb;
    uint8_t* o = out + static_cast<size_t>(c) * nl * lane +
                 static_cast<size_t>(k) * lane;
    const int ns = min(max(length - k * lane, 0), lane);
    uint64_t win = (static_cast<uint64_t>(wb > 0 ? w[0] : 0u) << 32) |
                   (wb > 1 ? w[1] : 0u);
    int navail = 64;  // invariant: >= 32 valid bits before each symbol
    int cur = 2;
    uint32_t pack = 0;
    for (int j = 0; j < lane; ++j) {
      uint32_t sym = 0;
      if (j < ns) {
        const uint32_t hi = static_cast<uint32_t>(win >> 32);
        int l = 0;
        long long idx = 0;
        for (int t = 1; t <= max_len; ++t) {
          const long long v = hi >> (32 - t);
          if (v < bound[t]) {
            l = t;
            idx = base[t] + v;
            break;
          }
        }
        sym = canon[idx < 0 ? 0 : (idx > 255 ? 255 : idx)];
        win <<= l;
        navail -= l;
        if (navail < 32) {
          const uint32_t nw = cur < wb ? w[cur] : 0u;
          win |= static_cast<uint64_t>(nw) << (32 - navail);
          ++cur;
          navail += 32;
        }
      }
      pack |= sym << (8 * (j & 3));
      if ((j & 3) == 3) {
        *reinterpret_cast<uint32_t*>(o + j - 3) = pack;
        pack = 0;
      }
    }
  }
}

}  // namespace

extern "C" int lane_decode_launch(const void* buf, const void* lens_tables,
                                  const void* lengths, void* out, int C,
                                  int nl, int wb, int lane, int max_len,
                                  void* stream) {
  lane_decode_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf),
      static_cast<const uint8_t*>(lens_tables),
      static_cast<const int*>(lengths), static_cast<uint8_t*>(out), nl, wb,
      lane, max_len);
  return static_cast<int>(cudaGetLastError());
}
