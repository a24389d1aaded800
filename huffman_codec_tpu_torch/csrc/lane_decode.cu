// Canonical Huffman decode of padded lanes.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, lane_decode
// (pallas_call at line 531, body _lane_decode_kernel).
//
// Contract: buf (C, nl, wb) u32, lane k of chunk c MSB-first from word 0;
// lens_tables (C, 256) u8 code lengths; lengths (C,) i32 symbols per chunk
// -> out (C, nl * lane) u8, any lane, where lane k decodes
// clip(lengths[c] - k*lane, 0, lane) symbols and every other byte is 0.
// A symbol's code length is the first l in 1..max_len with
// (window >> (32 - l)) < bound[l], its canonical index base[l] + that
// prefix, its symbol canon_syms[index]; when no l passes, the symbol is
// canon_syms[0] and the bit position stays. Canonical order is ascending
// (length, symbol) and first_code[l] = (first_code[l-1] + count[l-1]) << 1.
//
// Bound on the H100: the serial chain of each lane (a symbol starts where
// the previous one ended). The bytes are few, and about one table lookup
// and a few shifts a symbol are the operations. Design: one block per
// (chunk, group of G lanes), 256 threads, one thread per lane of the group.
// G is sized from wb so that the group's words and output fit the shared
// memory of a quarter SM, which keeps a few hundred chains in flight on
// every SM at lane 512 as at lane 2048 and 4096.
//   - The group's lanes are contiguous in buf: their words are copied to
//     shared memory with 16-byte cp.async while the tables are built, so
//     no refill of a chain goes to device memory.
//   - Tables: bound, base and canon_syms from the code lengths (the rank of
//     a symbol in its length class by warp match and a prefix over 32-symbol
//     groups, not a loop over the symbols before it; first_code as a sum,
//     every length at once), then a table of the up to three codes each
//     11-bit prefix holds whole. A code's length is found without a search:
//     the prefix tests fail below it and pass from it on, so it is one plus
//     the count of failing tests. A code longer than 11 bits takes the same
//     count over the lengths from 12 on.
//   - The chain: a left-justified 64-bit window, one table load a step of
//     up to three symbols, the next word always loaded ahead of its refill.
//   - Output: each thread writes its lane's symbols into a shared row, 4
//     bytes a store; then the block stores the group's contiguous output
//     coalesced, 16 bytes a thread (4 where lane % 16 != 0, 1 where
//     lane % 4 != 0, since the group's output then starts off a 4-byte
//     line), zeros past each lane's symbols included, so an empty lane
//     costs no decode loop.
// A lane is not split over threads: kernel 7's speculative decode at every
// bit position costs a table decode a bit (3.2 a symbol on the sharded
// step's data) and two doubling passes, about 58 operations a symbol
// against this chain's 10, which at that step is as long at the INT32
// rate as the chain takes on the card.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 31;
constexpr int kLutBits = 11;
// dynamic shared bytes of one group: four blocks and their tables fit an SM
constexpr int kGroupBudget = 42 * 1024;
constexpr int kMaxSmem = 212 * 1024;  // 227 KB less the static tables

__device__ __forceinline__ int clampi(long long v) {
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<int>(v));
}

// length << 8 | symbol of the code that starts window ``hi``, given that
// none of at most ``t0 - 1`` bits does; (0, canon_syms[0]) when none of at
// most max_len bits does. ``ljb[t]`` is bound[t] left-justified in 32 bits
// (clamped to 2^t, which changes no comparison): since bound[t+1] >=
// 2 bound[t], the prefix tests fail for all t below the code's length and
// pass from it on, so the length is t0 plus the count of failing tests.
__device__ __forceinline__ uint32_t code_at(uint32_t hi, int t0, int t1,
                                            const uint64_t* ljb,
                                            const long long* base,
                                            const uint8_t* canon) {
  int l = t0;
  for (int t = t0; t <= t1; ++t) l += hi >= ljb[t];
  if (l > t1) return canon[0];
  return (static_cast<uint32_t>(l) << 8) |
         canon[clampi(base[l] + (hi >> (32 - l)))];
}

// kBytes: the output is stored a byte a thread (lane % 4 != 0), in an
// instance of its own, so the other lanes' instance is compiled as before
template <bool kBytes>
__global__ void __launch_bounds__(kThreads)
lane_decode_kernel(const uint32_t* __restrict__ buf,
                   const uint8_t* __restrict__ lens_tables,
                   const int* __restrict__ lengths, uint8_t* __restrict__ out,
                   int nl, int wb, int lane, int max_len, int G, int bpc,
                   int ws, int os) {
  __shared__ int gcnt[8][kMaxLen + 2];  // class counts of 32-symbol groups
  __shared__ int bl_count[kMaxLen + 2];
  __shared__ int start_index[kMaxLen + 2];
  __shared__ uint64_t ljb[kMaxLen + 1];
  __shared__ long long base[kMaxLen + 1];
  __shared__ uint8_t canon[256];
  __shared__ uint32_t lutm[1 << kLutBits];   // up to three codes
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_out = smem + static_cast<size_t>(G) * ws * 4;

  const int c = blockIdx.x / bpc;
  const int k0 = (blockIdx.x - c * bpc) * G;
  const int g_n = min(G, nl - k0);  // lanes of this block
  const int tid = threadIdx.x;
  const int length = lengths[c];
  uint8_t* o = out + (static_cast<size_t>(c) * nl + k0) * lane;
  const int n_out = g_n * lane;  // < 2^31: the group fits shared memory
  const bool any = length - k0 * lane > 0;  // the first lane has symbols

  if (any) {
    // -- stage the group's words (asynchronous), zero each row's pad ------
    const uint32_t* w = buf + (static_cast<size_t>(c) * nl + k0) * wb;
    const int n_words = g_n * wb;
    if ((wb & 3) == 0) {
      for (int q = tid * 4; q < n_words; q += kThreads * 4) {
        const int r = q / wb;
        __pipeline_memcpy_async(s_words + r * ws + (q - r * wb), w + q, 16);
      }
    } else {
      for (int q = tid; q < n_words; q += kThreads) {
        const int r = q / wb;
        __pipeline_memcpy_async(s_words + r * ws + (q - r * wb), w + q, 4);
      }
    }
    __pipeline_commit();
    const int pad = ws - wb;
    for (int q = tid; q < g_n * pad; q += kThreads) {
      const int r = q / pad;
      s_words[r * ws + wb + (q - r * pad)] = 0u;
    }

    // -- bound, base, canon_syms of this chunk's code ----------------------
    for (int i = tid; i < 8 * (kMaxLen + 2); i += kThreads) {
      gcnt[i / (kMaxLen + 2)][i % (kMaxLen + 2)] = 0;
    }
    __syncthreads();
    const unsigned lt = (1u << (tid & 31)) - 1u;
    constexpr int kSymsPerThread = 256 / kThreads;
    int cls[kSymsPerThread];
    unsigned peers[kSymsPerThread];
#pragma unroll
    for (int h = 0; h < kSymsPerThread; ++h) {  // symbol tid + h * kThreads
      const int s = tid + h * kThreads;
      const int l = lens_tables[static_cast<size_t>(c) * 256 + s];
      cls[h] = l > 0 ? min(l, kMaxLen + 1) : kMaxLen + 1;
      peers[h] = __match_any_sync(0xFFFFFFFFu, cls[h]);
      if ((peers[h] & lt) == 0) gcnt[s >> 5][cls[h]] = __popc(peers[h]);
    }
    __syncthreads();
    if (tid < kMaxLen + 2) {  // exclusive prefix over the groups
      int run = 0;
      for (int g = 0; g < 8; ++g) {
        const int v = gcnt[g][tid];
        gcnt[g][tid] = run;
        run += v;
      }
      bl_count[tid] = run;
    }
    __syncthreads();
    if (tid <= kMaxLen + 1) {
      // first_code[l] = (first_code[l-1] + count[l-1]) << 1, unrolled into
      // a sum, so every length is computed at once
      unsigned long long code = 0;
      int start = 0;
      for (int k = 1; k < tid; ++k) {
        code += static_cast<unsigned long long>(bl_count[k]) << (tid - k);
        start += bl_count[k];
      }
      start_index[tid] = start;
      if (tid >= 1 && tid <= kMaxLen) {
        const unsigned long long bound = code + bl_count[tid];
        const unsigned long long cap = 1ull << tid;
        ljb[tid] = (bound < cap ? bound : cap) << (32 - tid);
        base[tid] = start - static_cast<long long>(code);
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kSymsPerThread; ++h) {
      const int s = tid + h * kThreads;
      canon[start_index[cls[h]] + gcnt[s >> 5][cls[h]] +
            __popc(peers[h] & lt)] = static_cast<uint8_t>(s);
    }
    __syncthreads();
    // the codes each 11-bit prefix holds whole, up to three: symbols in
    // bytes 0-2, their count in bits 24-25, their total length in bits
    // 26-31; 0 when the first code is longer than the prefix or there is
    // none. The prefix tests of code_at, on 11-bit prefixes, in registers;
    // past max_len a test repeats the one at max_len, which keeps the
    // count of failing tests the length.
    uint32_t lj[kLutBits + 1];
#pragma unroll
    for (int t = 1; t <= kLutBits; ++t) {
      lj[t] = static_cast<uint32_t>(ljb[min(t, max_len)] >> (32 - kLutBits));
    }
    for (int p = tid; p < (1 << kLutBits); p += kThreads) {
      uint32_t m = 0;
      int tot = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint32_t q = (static_cast<uint32_t>(p) << tot) &
                           ((1u << kLutBits) - 1);
        int l = 1;
#pragma unroll
        for (int t = 1; t <= kLutBits; ++t) l += q >= lj[t];
        if (tot + l > kLutBits) break;  // longer than the prefix, or none
        const uint32_t sym = canon[clampi(base[l] + (q >> (kLutBits - l)))];
        m = (m & ~(3u << 24)) | sym << (8 * k) |
            static_cast<uint32_t>(k + 1) << 24;
        tot += l;
      }
      lutm[p] = m | static_cast<uint32_t>(tot) << 26;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // -- one chain a lane ---------------------------------------------------
    if (tid < g_n) {
      const int ns = min(max(length - (k0 + tid) * lane, 0), lane);
      const uint32_t* sw = s_words + tid * ws;
      uint8_t* so = s_out + tid * os;
      uint64_t win = (static_cast<uint64_t>(sw[0]) << 32) | sw[1];
      int navail = 64;  // invariant: >= 32 valid bits before each symbol
      int cur = 2;
      uint32_t nxt = sw[min(cur, wb)];
      // each step takes the codes its 11-bit prefix holds whole (about
      // three at this data's 3.2 bits a symbol); the bytes written past a
      // step's count are overwritten by the next step or masked at the store
      // the symbols gather in a 64-bit register and leave 4 bytes a store
      uint64_t acc = 0;
      int nacc = 0, jw = 0;
      // the table's shared address pinned in a register: left alone, the
      // compiler recomputes it from the CTA's cluster rank every step
      uint32_t lut_addr =
          static_cast<uint32_t>(__cvta_generic_to_shared(lutm));
      asm volatile("mov.b32 %0, %0;" : "+r"(lut_addr));
      for (int j = 0; j < ns;) {
        const uint32_t hi = static_cast<uint32_t>(win >> 32);
        uint32_t e;
        asm volatile("ld.shared.u32 %0, [%1];"
                     : "=r"(e)
                     : "r"(lut_addr + 4 * (hi >> (32 - kLutBits))));
        int l = static_cast<int>(e >> 26);
        if (e == 0) {  // a code longer than the prefix, or none
          const uint32_t f = code_at(hi, kLutBits + 1, max_len, ljb, base,
                                     canon);
          l = static_cast<int>(f >> 8);
          e = (f & 255u) | 1u << 24;
        }
        const int cnt = static_cast<int>(e >> 24) & 3;
        acc |= static_cast<uint64_t>(e & 0xFFFFFFu) << (8 * nacc);
        nacc += cnt;
        j += cnt;
        if (nacc >= 4) {
          *reinterpret_cast<uint32_t*>(so + jw) = static_cast<uint32_t>(acc);
          acc >>= 32;
          nacc -= 4;
          jw += 4;
        }
        // consume, and refill from the word loaded ahead without a branch
        win <<= l;
        navail -= l;
        const bool refill = navail < 32;
        win |= refill ? static_cast<uint64_t>(nxt) << ((32 - navail) & 63)
                      : 0ull;
        navail += refill ? 32 : 0;
        cur += refill;
        nxt = refill ? sw[min(cur, wb)] : nxt;  // sw[wb] is a zero pad word
      }
      if (nacc) {
        *reinterpret_cast<uint32_t*>(so + jw) = static_cast<uint32_t>(acc);
      }
    }
    __syncthreads();
  }

  // -- the group's output, coalesced; zeros past each lane's symbols -------
  if (kBytes) {
    for (int q = tid; q < n_out; q += kThreads) {
      const int kk = q / lane;
      const int j = q - kk * lane;
      const int ns = min(max(length - (k0 + kk) * lane, 0), lane);
      o[q] = j < ns ? s_out[kk * os + j] : 0;
    }
  } else if ((lane & 15) == 0) {
    for (int q = tid * 16; q < n_out; q += kThreads * 16) {
      const int kk = q / lane;
      const int j = q - kk * lane;
      const int ns = min(max(length - (k0 + kk) * lane, 0), lane);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < ns) {
        v = *reinterpret_cast<const uint4*>(s_out + kk * os + j);
        if (ns - j < 16) {
          unsigned* vw = reinterpret_cast<unsigned*>(&v);
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            if (j + b >= ns) vw[b >> 2] &= ~(255u << (8 * (b & 3)));
          }
        }
      }
      *reinterpret_cast<uint4*>(o + q) = v;
    }
  } else {
    for (int q = tid * 4; q < n_out; q += kThreads * 4) {
      const int kk = q / lane;
      const int j = q - kk * lane;
      const int ns = min(max(length - (k0 + kk) * lane, 0), lane);
      unsigned v = 0u;
      if (j < ns) {
        v = *reinterpret_cast<const unsigned*>(s_out + kk * os + j);
        for (int b = 0; b < 4; ++b) {
          if (j + b >= ns) v &= ~(255u << (8 * b));
        }
      }
      *reinterpret_cast<unsigned*>(o + q) = v;
    }
  }
}

}  // namespace

extern "C" int lane_decode_launch(const void* buf, const void* lens_tables,
                                  const void* lengths, void* out, int C,
                                  int nl, int wb, int lane, int max_len,
                                  void* stream) {
  if (C == 0 || nl == 0) return 0;
  const int ws = (wb + 1 + 3) & ~3;        // words a lane, a zero pad word
  const int os = ((lane + 15) & ~15) + 16;  // output bytes a lane
  const int per_lane = ws * 4 + os;
  if (per_lane > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int g_max = max(1, min(kThreads, kGroupBudget / per_lane));
  const int bpc = (nl + g_max - 1) / g_max;  // blocks a chunk
  const int G = (nl + bpc - 1) / bpc;
  const int smem = G * per_lane;
  auto* kernel = (lane & 3) ? lane_decode_kernel<true>
                            : lane_decode_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<C * bpc, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf),
      static_cast<const uint8_t*>(lens_tables),
      static_cast<const int*>(lengths), static_cast<uint8_t*>(out), nl, wb,
      lane, max_len, G, bpc, ws, os);
  return static_cast<int>(cudaGetLastError());
}
