// Canonical Huffman lane pack: table lookup, then MSB-first bit packing
// into word-aligned lanes.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, lane_pack
// (pallas_call at line 312, bodies _lane_pack_kernel and _lane_pack_body).
//
// Contract: data (C, L) u8, lens (C,) i32, tables (C, 256) i32 holding
// code | len << 26 (read as code = entry & (2^26 - 1), len = entry >> 26,
// as the JAX package reads them) -> words (C, L/lane, W) u32 and bits
// (C, L/lane) i32. Lane k of chunk c packs symbols [k*lane, (k+1)*lane)
// that lie below lens[c], MSB-first from word 0; every word past the
// lane's last used one is 0, and so is column W - 1 (the TPU wrapper's
// bit-count column, which it zeroes after reading).
//
// Bound on the H100: bytes. The padded output (W words per lane, about 10x
// the payload at 3.2 bits a symbol) dominates the traffic; the symbols
// are read once.
//
// Design: symbols to threads, not lanes to threads. A thread takes 16
// consecutive symbols of a lane with one 16-byte load and sums their code
// lengths from the chunk's table in shared memory; a block-wide exclusive
// scan of those sums gives each thread its bit offset in its lane. The
// thread then builds its up to 496 bits into up to 17 words with a 64-bit
// accumulator and puts them into a shared-memory copy of the lane's words:
// plain stores for the words it owns, a shared atomicOr for its first and
// last word, which it may share with its neighbours. Last, the block
// stores the lanes' whole W-word rows, payload and zero tail alike, with
// coalesced 16-byte stores. Two shapes of one function:
//
// * lane <= 4096: a team of ceil(lane/16) threads a lane (one warp at
//   lane 512, the whole block at 4096), as many lanes a block as fit in
//   its 256 threads, all of one chunk; the scan over the block is cut into
//   lanes by subtracting the offset of each lane's first thread.
// * lane > 4096 (the whole-file candidate's fat lanes, up to 32768): a
//   block a lane walks it in pieces of 4096 symbols, carrying the bit
//   offset and the unfinished 16-byte group of words from piece to piece
//   and storing each finished run of groups as it goes, so its shared
//   memory does not grow with the lane.
//
// Any lane dividing L: when lane and L divide by 16 every thread's 16
// symbols are one aligned 16-byte load; otherwise a thread's group may
// stop at its lane's end (the last group holds lane % 16 symbols) and its
// symbols are loaded a byte at a time. The word rows (W, a multiple of
// 128) are stored as 16-byte lines either way.
//
// (The TPU kernel's one-hot lookups and butterfly placement exist only
// because the TPU has no gather or scatter.)

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = kThreads * 16;  // symbols a block takes at once
constexpr uint32_t kMask26 = (1u << 26) - 1;
// a piece's words: 4096 codes of at most 31 bits, after up to 4 words
// carried over, in whole 16-byte groups
constexpr int kFatWords = 4000;

using Scan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;

__device__ __forceinline__ uint32_t sym(const uint4& v, int j) {
  const uint32_t w = j < 8 ? (j < 4 ? v.x : v.y) : (j < 12 ? v.z : v.w);
  return (w >> (8 * (j & 3))) & 255;
}

// The first m (1..16) symbols at p: one 16-byte load where p is aligned,
// else byte loads (the bytes from m on are 0 and never used).
__device__ __forceinline__ uint4 load_syms(const uint8_t* p, int m,
                                          bool aligned) {
  if (aligned) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < m) w[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Code bits of the first m (<= 16) symbols held in v.
__device__ __forceinline__ int count_bits(const uint32_t* tab, const uint4& v,
                                          int m) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < m) s += tab[sym(v, j)] >> 26;
  }
  return s;
}

// Put the codes of the first m symbols held in v at bit b of the staged
// words wb (words at index lim or beyond are dropped). The first and the
// last word may be shared with the threads before and after: atomicOr.
__device__ __forceinline__ void put_codes(uint32_t* wb, int lim,
                                          const uint32_t* tab, const uint4& v,
                                          int m, int b) {
  if (m <= 0) return;
  int w = b >> 5;
  int nb = b & 31;  // bits waiting in acc (the first ones belong to others)
  uint64_t acc = 0;
  bool first = true;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < m) {
      const uint32_t e = tab[sym(v, j)];
      const int len = e >> 26;
      acc = (acc << len) | (e & kMask26);
      nb += len;
      if (nb >= 32) {
        nb -= 32;
        const uint32_t word = static_cast<uint32_t>(acc >> nb);
        if (w < lim) {
          if (first) {
            atomicOr(wb + w, word);
          } else {
            wb[w] = word;
          }
        }
        first = false;
        ++w;
      }
    }
  }
  if (nb > 0 && w < lim) {
    atomicOr(wb + w, static_cast<uint32_t>(acc << (32 - nb)));
  }
}

__device__ __forceinline__ void load_table(uint32_t* tab, const int* tables,
                                           int c) {
  tab[threadIdx.x] = static_cast<uint32_t>(
      tables[static_cast<size_t>(c) * 256 + threadIdx.x]);
}

// lane <= 4096: `lpb` lanes of one chunk a block, `team` threads a lane,
// each lane's payload staged at `pw` words (a multiple of 4). Eight blocks
// an SM (32 registers): the stores of some overlap the others' scans.
__global__ void __launch_bounds__(kThreads, 8)
lane_pack_narrow(const uint8_t* __restrict__ data,
                 const int* __restrict__ lens, const int* __restrict__ tables,
                 uint32_t* __restrict__ words, int* __restrict__ bits, int L,
                 int lane, int W, int team, int lpb, int pw, int gpc,
                 bool aligned) {
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ uint32_t tab[256];
  __shared__ int pre[kThreads + 1];
  extern __shared__ uint4 buf4[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(buf4);

  const int nl = L / lane;
  const int c = blockIdx.x / gpc;
  const int k0 = (blockIdx.x - c * gpc) * lpb;
  const int nlanes = min(lpb, nl - k0);
  load_table(tab, tables, c);
  for (int i = threadIdx.x; i < lpb * pw / 4; i += kThreads) {
    buf4[i] = make_uint4(0, 0, 0, 0);
  }
  const int length = min(max(lens[c], 0), L);
  const int j = threadIdx.x / team;
  const int g = threadIdx.x - j * team;
  const bool act = j < nlanes;
  const int k = k0 + j;
  const int ns = act ? min(max(length - k * lane, 0), lane) : 0;
  const int m = min(max(ns - 16 * g, 0), 16);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (m > 0) {
    v = load_syms(data + static_cast<size_t>(c) * L +
                      static_cast<size_t>(k) * lane + 16 * g,
                  m, aligned);
  }
  __syncthreads();  // the table
  int excl, agg;
  Scan(scan_tmp).ExclusiveSum(count_bits(tab, v, m), excl, agg);
  pre[threadIdx.x] = excl;
  if (threadIdx.x == 0) pre[kThreads] = agg;
  __syncthreads();
  if (act) {
    const int first = pre[j * team];
    put_codes(buf + j * pw, min(pw, W - 1), tab, v, m, excl - first);
    if (g == 0) {
      bits[static_cast<size_t>(c) * nl + k] = pre[(j + 1) * team] - first;
    }
  }
  __syncthreads();
  // the block's lanes are consecutive rows of W words
  uint4* out = reinterpret_cast<uint4*>(
      words + (static_cast<size_t>(c) * nl + k0) * W);
  const int row4 = W / 4, pw4 = pw / 4;
  int jj = threadIdx.x / row4;  // lane and group of the thread's next store
  int w4 = threadIdx.x - jj * row4;
  for (int u = threadIdx.x; u < nlanes * row4; u += kThreads) {
    uint4 val = w4 < pw4 ? buf4[jj * pw4 + w4] : make_uint4(0, 0, 0, 0);
    if (w4 == row4 - 1) val.w = 0;  // column W - 1
    out[u] = val;
    for (w4 += kThreads; w4 >= row4; w4 -= row4) ++jj;
  }
}

// lane > 4096: a block a lane, pieces of 4096 symbols.
__global__ void __launch_bounds__(kThreads)
lane_pack_fat(const uint8_t* __restrict__ data, const int* __restrict__ lens,
              const int* __restrict__ tables, uint32_t* __restrict__ words,
              int* __restrict__ bits, int L, int lane, int W,
              bool aligned) {
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ uint32_t tab[256];
  __shared__ __align__(16) uint4 buf4[kFatWords / 4];
  uint32_t* buf = reinterpret_cast<uint32_t*>(buf4);

  const int nl = L / lane;
  const int c = blockIdx.x / nl;
  const int k = blockIdx.x - c * nl;
  load_table(tab, tables, c);
  for (int i = threadIdx.x; i < kFatWords / 4; i += kThreads) {
    buf4[i] = make_uint4(0, 0, 0, 0);
  }
  const int length = min(max(lens[c], 0), L);
  const int ns = min(max(length - k * lane, 0), lane);
  const uint8_t* x =
      data + static_cast<size_t>(c) * L + static_cast<size_t>(k) * lane;
  uint4* out = reinterpret_cast<uint4*>(
      words + (static_cast<size_t>(c) * nl + k) * W);
  const int row4 = W / 4;
  int carry = 0;  // bits of the lane packed so far
  int base4 = 0;  // the 16-byte group of the row that buf4[0] holds
  auto load = [&](int p0, int& m) {
    m = min(max(ns - p0 - 16 * static_cast<int>(threadIdx.x), 0), 16);
    return m > 0 ? load_syms(x + p0 + 16 * threadIdx.x, m, aligned)
                 : make_uint4(0, 0, 0, 0);
  };
  int m;
  uint4 v = load(0, m);
  __syncthreads();  // the table and the zeroed buffer
  for (int p0 = 0; p0 < ns; p0 += kPiece) {
    int m_next;
    const uint4 v_next = load(p0 + kPiece, m_next);  // in flight meanwhile
    int excl, agg;
    Scan(scan_tmp).ExclusiveSum(count_bits(tab, v, m), excl, agg);
    put_codes(buf, min(kFatWords, W - 1 - 4 * base4), tab, v, m,
              carry - 128 * base4 + excl);
    __syncthreads();
    carry += agg;
    // groups wholly below the word that bit `carry` falls in are final
    const int done4 = (carry >> 5) >> 2;
    for (int u = base4 + threadIdx.x; u < done4; u += kThreads) {
      uint4 val = buf4[u - base4];
      if (u == row4 - 1) val.w = 0;
      out[u] = val;
    }
    const uint4 keep = buf4[done4 - base4];  // the unfinished group
    __syncthreads();
    for (int i = threadIdx.x; i < kFatWords / 4; i += kThreads) {
      buf4[i] = i == 0 ? keep : make_uint4(0, 0, 0, 0);
    }
    base4 = done4;
    v = v_next;
    m = m_next;
    __syncthreads();
  }
  // the rest of the row: what is staged, then zeros
  for (int u = base4 + threadIdx.x; u < row4; u += kThreads) {
    uint4 val = u - base4 < kFatWords / 4 ? buf4[u - base4]
                                          : make_uint4(0, 0, 0, 0);
    if (u == row4 - 1) val.w = 0;
    out[u] = val;
  }
  if (threadIdx.x == 0) bits[static_cast<size_t>(c) * nl + k] = carry;
}

}  // namespace

extern "C" int lane_pack_launch(const void* data, const void* lens,
                                const void* tables, void* words, void* bits,
                                int C, int L, int lane, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nl = L / lane;
  if (C == 0 || nl == 0) return 0;
  // every 16-symbol group starts on a 16-byte line (data is aligned)
  const bool aligned = lane % 16 == 0;
  if (lane > kPiece) {
    lane_pack_fat<<<static_cast<unsigned>(C) * nl, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
        static_cast<const int*>(tables), static_cast<uint32_t*>(words),
        static_cast<int*>(bits), L, lane, W, aligned);
  } else {
    const int team = (lane + 15) / 16;
    const int lpb = kThreads / team;
    const int gpc = (nl + lpb - 1) / lpb;  // blocks a chunk
    // a lane's payload: at most 31 bits a symbol, in whole 16-byte groups
    const int pw = ((lane * 31 + 31) / 32 + 3) / 4 * 4;
    const size_t smem = static_cast<size_t>(lpb) * pw * sizeof(uint32_t);
    lane_pack_narrow<<<static_cast<unsigned>(C) * gpc, kThreads, smem, s>>>(
        static_cast<const uint8_t*>(data), static_cast<const int*>(lens),
        static_cast<const int*>(tables), static_cast<uint32_t*>(words),
        static_cast<int*>(bits), L, lane, W, team, lpb, pw, gpc, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}
