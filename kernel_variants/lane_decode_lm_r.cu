// Variant of huffman_codec_tpu_torch/csrc/lane_decode_lm.cu for timing
// (kernel_variants/time_decode_variants.py): the package's kernel with
// the number of resynchronising rounds before the exact maps set by
// -DROUNDS (the package's is 4). ROUNDS=0 takes the maps whenever the
// speculation is not exact, which also holds the maps to the package's
// output on every input the script times.

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
// canon_syms[0] and the bit position stays. Words past wb read as 0. This
// is the geometry of a whole-file container: at most 112 lanes of up to
// 32768 symbols each.
//
// Bound on the H100: bytes (a few megabytes) and a table lookup or so a
// symbol; what stands between a kernel and that bound is the chain of a
// lane, each symbol starting where the previous one ended. A block walking
// its lane alone (the design before this one: one thread, four symbols a
// step through speculative tables) takes 8192 dependent steps for a lane
// of 32768 symbols while the rest of the card waits.
//
// Design: the chain is cut, not sped up. One block of 1024 threads a lane;
// the lane's wb * 32 bits are cut into sub-sequences of S bits, one a
// thread, and the words are staged in shared memory. S is chosen by the
// caller (kernels.fat_subseq_bits): the fewest words that let 1024 cover
// the lane, at least 3 and odd, so that the words a warp's threads read
// at once fall in 32 different banks (160 bits at the corpus image's 3.2
// bits a symbol; 8 words, a multiple of the banks' stride, cost a third
// more time on random bytes). The block builds the chunk's tables there
// (bound, base, canon_syms; for every 11-bit prefix the up to three codes
// it holds whole, and its first code alone).
//   1. Speculate: each thread decodes from its sub-sequence's first bit
//      until a symbol would start at or past the sub-sequence's end, and
//      records its exit (0 to max_len - 1 bits into the next sub-sequence)
//      and its symbol count. Thread 0 starts at bit 0, which is exact.
//   2. Synchronise: a thread whose entry (its predecessor's exit) differs
//      from where it started decodes again from that entry, all such
//      threads at once, round after round. The first unstable sub-sequence
//      U (a block min) bounds the exact part: every sub-sequence before U
//      entered where its predecessor left, so all of them are right. The
//      rounds stop when none is unstable, when the exact part already holds
//      the lane's symbols (a block sum of its counts), or when the first
//      event on the chain is a window with no valid code. Codes of mixed
//      lengths resynchronise within a few codes, so one or two rounds are
//      typical.
//   3. Exact past four rounds: codes that never resynchronise (a fixed
//      length that does not divide the sub-sequences' starts) move U by one
//      sub-sequence a round. Then every sub-sequence from U on maps each of
//      its max_len possible entries to its exit (max_len decodes a thread,
//      in parallel), and thread 0 composes the maps from U's true entry to
//      the end, one shared load a sub-sequence.
//   4. Place: an exclusive block scan of the counts gives each
//      sub-sequence its first output index; each decodes once more from its
//      true entry into a shared row of the lane's output, stopping at the
//      lane's symbol count, and the block stores the row in 16-byte lines.
// A chain that meets a window with no valid code, or runs past the lane's
// last word (a window of zeros is canon_syms[0], whatever the table), has
// canon_syms[0] for every later symbol: the symbols after the decoded ones
// are filled with it. Speculative chains that meet such a window are
// dropped when their entry changes. Inside a sub-sequence a step takes the
// up to three codes its 11-bit prefix holds while all of them start before
// the sub-sequence's end, else one code. (The TPU kernel's register tile,
// bit-plane symbol lookup and one-hot word refill stand in for a gather it
// does not have.)

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 1024;  // a sub-sequence a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLen = 31;
constexpr int kLutBits = 11;
#ifndef ROUNDS
#define ROUNDS 4
#endif
constexpr int kRounds = ROUNDS;  // resynchronising rounds before the maps
constexpr int kPadWords = 4;  // zero words after the lane's wb
constexpr int kStuckBit = 1 << 30;  // an exit flag: no valid code there
constexpr uint8_t kStuckMap = 0xFF;

__device__ __forceinline__ int clampi(long long v) {
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<int>(v));
}

struct Tables {
  const uint32_t* lutm;  // up to three whole codes of an 11-bit prefix
  const uint16_t* lut1;  // its first code alone
  const uint64_t* ljb;
  const long long* base;
  const uint8_t* canon;
  int max_len;
};

// length << 8 | symbol of the code that starts window ``hi``, given that
// none of at most ``t0 - 1`` bits does; length 0 (and canon_syms[0]) when
// none of at most max_len bits does. ``ljb[t]`` is bound[t] left-justified
// in 32 bits (clamped to 2^t, which changes no comparison): the prefix
// tests fail below the code's length and pass from it on, so the length
// is t0 plus the count of failing tests.
__device__ __forceinline__ uint32_t code_at(uint32_t hi, int t0,
                                            const Tables& tb) {
  int l = t0;
  for (int t = t0; t <= tb.max_len; ++t) l += hi >= tb.ljb[t];
  if (l > tb.max_len) return tb.canon[0];
  return (static_cast<uint32_t>(l) << 8) |
         tb.canon[clampi(tb.base[l] + (hi >> (32 - l)))];
}

// Decode from bit p while a symbol starts before ``end``; p ends at the
// exit (or where a window holds no valid code: then ``stuck``). Returns the
// symbols decoded. With kWrite, symbol j goes to so[at + j] while
// at + j < ns, and the walk stops once ns is reached.
template <bool kWrite>
__device__ __forceinline__ int decode_run(const uint32_t* sw, int& p, int end,
                                          bool& stuck, const Tables& tb,
                                          uint8_t* so = nullptr, int at = 0,
                                          int ns = 0) {
  int cnt = 0;
  stuck = false;
  while (p < end) {
    if (kWrite && at + cnt >= ns) break;
    const int wi = p >> 5;
    const uint32_t hi = __funnelshift_l(sw[wi + 1], sw[wi], p & 31);
    const uint32_t pre = hi >> (32 - kLutBits);
    if (p + kLutBits <= end) {  // every code of the entry starts before end
      const uint32_t e = tb.lutm[pre];
      if (e) {
        const int n = static_cast<int>(e >> 24) & 3;
        if (kWrite) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if (j < n && at + cnt + j < ns) so[at + cnt + j] = e >> (8 * j);
          }
        }
        cnt += n;
        p += static_cast<int>(e >> 26);
        continue;
      }
    }
    uint32_t f = tb.lut1[pre];
    if (!f) f = code_at(hi, kLutBits + 1, tb);
    const int l = static_cast<int>(f >> 8);
    if (!l) {
      stuck = true;
      return cnt;
    }
    if (kWrite) so[at + cnt] = static_cast<uint8_t>(f);
    ++cnt;
    p += l;
  }
  return cnt;
}

__device__ __forceinline__ unsigned block_min(unsigned v, unsigned* red) {
  v = __reduce_min_sync(~0u, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = __reduce_min_sync(~0u, red[threadIdx.x & 31]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_sum(int v, unsigned* red) {
  v = __reduce_add_sync(~0u, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = __reduce_add_sync(~0u, static_cast<int>(red[threadIdx.x & 31]));
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
lane_decode_lm_kernel(const uint32_t* __restrict__ buf,
                      const uint8_t* __restrict__ lens_tables,
                      const int* __restrict__ lengths,
                      uint8_t* __restrict__ out, int nl, int wb, int lane,
                      int max_len, int S) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int gcnt[8][kMaxLen + 2];  // class counts of 32-symbol groups
  __shared__ int bl_count[kMaxLen + 2];
  __shared__ int start_index[kMaxLen + 2];
  __shared__ uint64_t ljb[kMaxLen + 1];
  __shared__ long long base[kMaxLen + 1];
  __shared__ uint8_t canon[256];
  __shared__ uint32_t lutm[1 << kLutBits];
  __shared__ uint16_t lut1[1 << kLutBits];
  __shared__ int s_exit[kThreads];   // exit bit (| kStuckBit) a sub-sequence
  __shared__ int s_entry[kThreads];  // true entries found by the maps
  __shared__ unsigned red[kWarps];
  __shared__ int s_T;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  // the lane's output row; before it, the maps of step 3
  uint8_t* s_out = smem + static_cast<size_t>(wb + kPadWords) * 4;

  const int tid = threadIdx.x;
  const int c = blockIdx.x / nl;
  const int k = blockIdx.x - c * nl;
  const uint32_t* w = buf + (static_cast<size_t>(c) * nl + k) * wb;
  uint8_t* o = out + (static_cast<size_t>(c) * nl + k) * lane;
  const int ns = min(max(lengths[c] - k * lane, 0), lane);
  int lim = 0;  // output bytes decoded; canon_syms[0] from there up to ns

  if (ns > 0) {
    // -- stage the lane's words (asynchronous), zero the pad -------------
    if ((wb & 3) == 0) {
      for (int q = tid * 4; q < wb; q += kThreads * 4) {
        __pipeline_memcpy_async(s_words + q, w + q, 16);
      }
    } else {
      for (int q = tid; q < wb; q += kThreads) {
        __pipeline_memcpy_async(s_words + q, w + q, 4);
      }
    }
    __pipeline_commit();
    if (tid < kPadWords) s_words[wb + tid] = 0u;

    // -- bound, base, canon_syms of this chunk's code (warps 0-7) ---------
    for (int i = tid; i < 8 * (kMaxLen + 2); i += kThreads) {
      gcnt[i / (kMaxLen + 2)][i % (kMaxLen + 2)] = 0;
    }
    __syncthreads();
    const unsigned lt = (1u << (tid & 31)) - 1u;
    int cls = 0;
    unsigned peers = 0;
    if (tid < 256) {
      const int l = lens_tables[static_cast<size_t>(c) * 256 + tid];
      cls = l > 0 ? min(l, kMaxLen + 1) : kMaxLen + 1;
      peers = __match_any_sync(0xFFFFFFFFu, cls);
      if ((peers & lt) == 0) gcnt[tid >> 5][cls] = __popc(peers);
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
      // first_code[l] = (first_code[l-1] + count[l-1]) << 1, as a sum
      unsigned long long code = 0;
      int start = 0;
      for (int j = 1; j < tid; ++j) {
        code += static_cast<unsigned long long>(bl_count[j]) << (tid - j);
        start += bl_count[j];
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
    if (tid < 256) {
      canon[start_index[cls] + gcnt[tid >> 5][cls] + __popc(peers & lt)] =
          static_cast<uint8_t>(tid);
    }
    __syncthreads();
    // the codes each 11-bit prefix holds whole, up to three: symbols in
    // bytes 0-2, their count in bits 24-25, their total length in bits
    // 26-31 (0: the first code is longer than the prefix, or none); and
    // its first code alone as length << 8 | symbol. Past max_len a prefix
    // test repeats the one at max_len, which keeps the count of failing
    // tests the length.
    uint32_t lj[kLutBits + 1];
#pragma unroll
    for (int t = 1; t <= kLutBits; ++t) {
      lj[t] = static_cast<uint32_t>(ljb[min(t, max_len)] >> (32 - kLutBits));
    }
    for (int p = tid; p < (1 << kLutBits); p += kThreads) {
      uint32_t m = 0, first = 0;
      int tot = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint32_t q = (static_cast<uint32_t>(p) << tot) &
                           ((1u << kLutBits) - 1);
        int l = 1;
#pragma unroll
        for (int t = 1; t <= kLutBits; ++t) l += q >= lj[t];
        if (tot + l > kLutBits) break;  // longer than the prefix, or none
        const uint32_t sym = canon[clampi(base[l] + (q >> (kLutBits - l)))];
        if (j == 0) first = static_cast<uint32_t>(l) << 8 | sym;
        m = (m & ~(3u << 24)) | sym << (8 * j) |
            static_cast<uint32_t>(j + 1) << 24;
        tot += l;
      }
      lutm[p] = m | static_cast<uint32_t>(tot) << 26;
      lut1[p] = static_cast<uint16_t>(first);
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    const Tables tb{lutm, lut1, ljb, base, canon, max_len};
    const int nb = wb * 32;
    const int n_sub = (nb + S - 1) / S;
    const bool act = tid < n_sub;
    const int start = tid * S;
    const int end = min(start + S, nb);

    // -- 1. speculate from every sub-sequence's first bit -----------------
    int entry = start, cnt = 0;
    bool stuck = false;
    if (act) {
      int p = entry;
      cnt = decode_run<false>(s_words, p, end, stuck, tb);
      s_exit[tid] = stuck ? (p | kStuckBit) : p;
    }

    // -- 2. resynchronise; 3. the exact maps past kRounds -----------------
    int T;  // the last sub-sequence whose symbols count
    for (int r = 0;; ++r) {
      __syncthreads();  // s_exit
      unsigned key = ~0u;  // 2i: i is unstable; 2i + 1: i met no code
      int want = entry;
      if (act) {
        if (tid > 0) {
          const int pe = s_exit[tid - 1];
          if (!(pe & kStuckBit) && pe != entry) {
            key = 2u * tid;
            want = pe;
          }
        }
        if (key == ~0u && stuck) key = 2u * tid + 1;
      }
      const unsigned first = block_min(key, red);
      if (first == ~0u) {  // every entry is exact
        T = n_sub - 1;
        break;
      }
      if (first & 1) {  // the exact chain meets a window with no code
        T = static_cast<int>(first >> 1);
        break;
      }
      const int U = static_cast<int>(first >> 1);
      if (block_sum(tid < U ? cnt : 0, red) >= ns) {  // enough symbols
        T = U - 1;
        break;
      }
      if (r == kRounds) {
        // every sub-sequence from U on: its exit from each entry offset
        uint8_t* maps = s_out;
        if (act && tid >= U) {
          for (int e = 0; e < max_len; ++e) {
            int p = start + e;
            bool st;
            decode_run<false>(s_words, p, end, st, tb);
            maps[tid * max_len + e] =
                st ? kStuckMap : static_cast<uint8_t>(p - end);
          }
        }
        __syncthreads();
        if (tid == 0) {
          int i = U;
          int e = s_exit[U - 1] - U * S;
          for (;; ++i) {
            s_entry[i] = i * S + e;
            const int m = maps[i * max_len + e];
            if (m == kStuckMap || i == n_sub - 1) break;
            e = m;
          }
          s_T = i;
        }
        __syncthreads();
        T = s_T;
        if (act && tid >= U && tid <= T) {
          entry = s_entry[tid];
          int p = entry;
          cnt = decode_run<false>(s_words, p, end, stuck, tb);
        }
        break;
      }
      if (want != entry) {  // s_exit was read before block_min's barriers
        entry = want;
        int p = entry;
        cnt = decode_run<false>(s_words, p, end, stuck, tb);
        s_exit[tid] = stuck ? (p | kStuckBit) : p;
      }
    }

    // -- 4. place the symbols ---------------------------------------------
    __syncthreads();  // the maps' space becomes the output row
    const int mine = act && tid <= T ? cnt : 0;
    int at, total;
    Scan(scan_tmp).ExclusiveSum(mine, at, total);
    if (mine && at < ns) {
      int p = entry;
      bool st;
      decode_run<true>(s_words, p, end, st, tb, s_out, at, ns);
    }
    lim = min(total, ns);
    __syncthreads();
  }

  // -- the row: decoded symbols, canon_syms[0] up to ns, then zeros --------
  const uint32_t fill = ns > lim ? canon[0] * 0x01010101u : 0u;
  for (int q = tid * 16; q < lane; q += kThreads * 16) {
    uint4 v;
    if (q + 16 <= lim) {
      v = *reinterpret_cast<const uint4*>(s_out + q);
    } else if (q >= lim && q + 16 <= ns) {
      v = make_uint4(fill, fill, fill, fill);
    } else if (q >= ns) {
      v = make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t x = q + j < lim ? s_out[q + j]
                                       : (q + j < ns ? fill & 255u : 0u);
        b[j >> 2] |= x << (8 * (j & 3));
      }
      v = make_uint4(b[0], b[1], b[2], b[3]);
    }
    *reinterpret_cast<uint4*>(o + q) = v;
  }
}

}  // namespace

extern "C" int lane_decode_lm_launch(const void* buf, const void* lens_tables,
                                     const void* lengths, void* out, int C,
                                     int nl, int wb, int lane, int max_len,
                                     int S, void* stream) {
  if (C == 0 || nl == 0) return 0;
  // S: whole words, at least 64 bits (more than a code, so an exit is at
  // most max_len - 1 bits into the next sub-sequence), and 1024 of them
  // cover the lane's bits; lanes in whole 16-byte lines
  if (S < 64 || S % 32 || wb < 1 || lane % 16 ||
      static_cast<long long>(S) * kThreads < 32ll * wb ||
      max_len < 1 || max_len > kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sub = (32 * wb + S - 1) / S;
  const size_t row = (static_cast<size_t>(lane) + 15) / 16 * 16;
  const size_t maps = static_cast<size_t>(n_sub) * max_len;
  const size_t smem = (static_cast<size_t>(wb) + kPadWords) * 4 +
                      (row > maps ? row : maps);
  const cudaError_t err = cudaFuncSetAttribute(
      lane_decode_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_decode_lm_kernel<<<C * nl, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf),
      static_cast<const uint8_t*>(lens_tables),
      static_cast<const int*>(lengths), static_cast<uint8_t*>(out), nl, wb,
      lane, max_len, S);
  return static_cast<int>(cudaGetLastError());
}
