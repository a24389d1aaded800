// MNP-5 decode of stream rows: count-byte classification, expansion and
// the optional per-chunk diff revert, in one kernel.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, rle_expand
// (pallas_call at line 1031, body _rle_expand_kernel), together with the
// XLA classification in front of it (huffman_codec_tpu/ops/rle.py,
// rle_classify).
//
// Contract: streams (C, n) u8, lens (C,) i32 valid stream bytes, carries
// (C,) u8 -> out (C, out_len) u8, out_len % 16 == 0 (the wrapper rounds
// it up and cuts the rows back: the output is a prefix of the decoded row
// either way). Any row length n below 2^31 - 2^21. Count bytes are those
// of the reference decoder's FSM (match, count <= 3) run from the start of
// each row. A literal stays itself and a count byte v becomes v repeats of
// the byte before it; with use_diff the result is the running sum mod 256
// seeded by the carry. Bytes past the decoded length are 0.
//
// Bound on the H100: integer operations. It reads each stream byte once and
// writes each output byte once, but a byte's class depends on every byte
// before it. Design: one block per row walks it in tiles of 16 consecutive
// sources per thread (256 threads; 32 for rows of at most 1024 bytes, the
// adaptive decodes' small tiles), staged in shared memory with 16-byte
// loads where the row allows.
//   1. Each thread maps the 8 abstract entry states of its 16 bytes
//      (ops/rle.py: count * 2 + (match == b0) for count < 3, 6 + (match ==
//      b1) when b0 is a count byte) to their exit states, packed into 24
//      bits. After the first byte the six count < 3 states leave only three
//      concrete states, after the second the two count-byte states one, so
//      four FSM chains give all eight exits. The two bytes after the
//      segment give the exit's abstract state.
//   2. A block-wide exclusive scan composes the maps; applied to the state
//      the previous tile left, it gives each thread its real entry state,
//      and the tile's aggregate carries that state to the next tile.
//   3. Each thread reruns its 16 bytes from that state to flag count bytes;
//      a block scan of the segments' packed (run length, run length * byte
//      mod 256) totals, carried from tile to tile, gives each source its
//      output offset and the diff sum of all it follows.
//   4. Output, staged: every source writes its run (diff reverted in place)
//      into a shared window of the tile's output that starts at a 16-byte
//      line, then the block stores the window's whole lines coalesced, 16
//      bytes a thread; the line the tile ends in waits in shared memory for
//      the next tile. (A gather, each thread owning 16-byte lines and
//      finding their sources by a binary search over the offsets, was
//      slower at the sharded step; PERF.md has both times.)
// Threads whose segment lies past the row's length skip steps 1 and 3.
// The block stops after the tile whose output reaches out_len: nothing
// after it is stored, and the 32-bit output offsets stay below out_len plus
// one tile's 2^20 bytes. The running diff sum is kept mod 256 from tile to
// tile, so it never carries into the offset packed above it.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kItems = 16;
constexpr int kPad = 16;  // the byte before the tile sits at kPad - 1
// the identity of the 8-state maps: state s -> s, 3 bits each
constexpr unsigned kIdentity = 0u | 1u << 3 | 2u << 6 | 3u << 9 | 4u << 12 |
                               5u << 15 | 6u << 18 | 7u << 21;

struct Compose {  // a, then b
  __device__ unsigned operator()(unsigned a, unsigned b) const {
    unsigned r = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const unsigned mid = (a >> (3 * s)) & 7u;
      r |= ((b >> (3 * mid)) & 7u) << (3 * s);
    }
    return r;
  }
};

// abstract entry state -> concrete (count, match); match -1 differs from
// every byte
__device__ __forceinline__ void enter(int s, int b0, int b1, int& count,
                                      int& match) {
  const int eq = s & 1;
  count = s < 6 ? s >> 1 : 3;
  match = eq ? (s < 6 ? b0 : b1) : -1;
}

// one byte of the reference decoder FSM; returns whether it is a count byte
__device__ __forceinline__ bool step(int& match, int& count, int c) {
  const bool is_cnt = count == 3;
  const bool eq = !is_cnt && match == c;
  if (!is_cnt) match = c;
  count = is_cnt ? 0 : (eq ? count + 1 : 1);
  return is_cnt;
}

// the abstract state in which the byte after a segment is entered
__device__ __forceinline__ unsigned exit_state(int count, int match, int n0,
                                               int n1) {
  return count < 3 ? count * 2 + (match == n0) : 6 + (match == n1);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
rle_expand_kernel(const uint8_t* __restrict__ streams,
                  const int* __restrict__ lens,
                  const uint8_t* __restrict__ carries,
                  uint8_t* __restrict__ out, int n, int out_len,
                  int use_diff) {
  constexpr int kTile = kThreads * kItems;
  using MapScan = cub::BlockScan<unsigned, kThreads>;
  using RunScan = cub::BlockScan<long long, kThreads>;
  __shared__ union {
    typename MapScan::TempStorage map;
    typename RunScan::TempStorage run;
  } tmp;
  __shared__ __align__(16) uint8_t s_x[kPad + kTile + 16];
  constexpr int kWin = 2 * kTile;  // output bytes staged at a time
  __shared__ __align__(16) uint8_t s_o[kWin];
  __shared__ __align__(16) uint8_t s_pend[16];  // a straddling group

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* x = streams + static_cast<size_t>(c) * n;
  uint8_t* o = out + static_cast<size_t>(c) * out_len;
  const int length = min(max(lens[c], 0), n);
  const int carry = carries[c];
  const bool aligned = (n & 15) == 0;  // then so is every tile of the row

  long long run = 0;  // (bytes written << 32) | sum of written bytes
  unsigned state = 0;  // abstract FSM state at the tile's first byte
  for (int t0 = 0; t0 < length; t0 += kTile) {
    // the tile and the two bytes after it; bytes at or past the length are
    // never used (a segment's later bytes and its exit only matter to
    // bytes after it)
    const int seg = t0 + tid * kItems;
    const int nvalid = min(max(length - seg, 0), kItems);
    if (aligned && seg + kItems <= n) {
      *reinterpret_cast<uint4*>(s_x + kPad + tid * kItems) =
          *reinterpret_cast<const uint4*>(x + seg);
    } else {
      for (int j = 0; j < nvalid; ++j) {
        s_x[kPad + tid * kItems + j] = x[seg + j];
      }
    }
    if (tid < 2 && t0 + kTile + tid < length) {
      s_x[kPad + kTile + tid] = x[t0 + kTile + tid];
    }
    if (tid == 0) s_x[kPad - 1] = t0 > 0 ? x[t0 - 1] : 0;
    __syncthreads();

    int b[kItems];
    {
      const uint4 q = *reinterpret_cast<const uint4*>(s_x + kPad +
                                                      tid * kItems);
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        b[j] = (w[j >> 2] >> (8 * (j & 3))) & 255;
      }
    }

    // 1. the segment's map over the 8 abstract entry states. After its
    //    first byte the six states with count < 3 leave only counts 1, 2
    //    and 3 (match b0), and after the second byte the two count-byte
    //    states leave (1, b1): four chains give all eight exits.
    unsigned map = kIdentity;
    if (nvalid > 0) {
      const int n0 = s_x[kPad + tid * kItems + kItems];
      const int n1 = s_x[kPad + tid * kItems + kItems + 1];
      unsigned ex[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int count = k < 3 ? k + 1 : 1;
        int match = k < 3 ? b[0] : b[1];
#pragma unroll
        for (int j = 1; j < kItems; ++j) {
          if (k < 3 || j > 1) step(match, count, b[j]);
        }
        ex[k] = exit_state(count, match, n0, n1);
      }
      // after b0: states 0, 1, 2, 4 -> count 1; 3 -> 2; 5 -> 3; 6, 7 -> D
      map = ex[0] | ex[0] << 3 | ex[0] << 6 | ex[1] << 9 | ex[0] << 12 |
            ex[2] << 15 | ex[3] << 18 | ex[3] << 21;
    }
    // 2. compose: the maps of the threads before this one
    unsigned before, agg;
    MapScan(tmp.map).ExclusiveScan(map, before, kIdentity, Compose(), agg);
    const int entry = (before >> (3 * state)) & 7u;
    state = (agg >> (3 * state)) & 7u;

    // 3. classify from the real entry state; the segment's totals
    unsigned cnt_mask = 0;
    int tot_rep = 0, tot_sum = 0;
    const int prev = s_x[kPad + tid * kItems - 1];
    if (nvalid > 0) {
      int count, match;
      enter(entry, b[0], b[1], count, match);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const bool cnt = step(match, count, b[j]);
        if (j < nvalid) {
          const int rep = cnt ? b[j] : 1;
          const int src = cnt ? (j > 0 ? b[j - 1] : prev) : b[j];
          cnt_mask |= static_cast<unsigned>(cnt) << j;
          tot_rep += rep;
          tot_sum += rep * src;
        }
      }
    }
    __syncthreads();  // tmp is reused
    long long mine = (static_cast<long long>(tot_rep) << 32) | (tot_sum & 255);
    long long tile_sum;
    RunScan(tmp.run).ExclusiveSum(mine, mine, tile_sum);
    const long long first = run + mine;
    const int A = static_cast<int>(run >> 32);
    run += tile_sum;
    run = (run & ~0xFFFFFFFFLL) | (run & 255);  // the sum mod 256
    const int B = static_cast<int>(run >> 32);

    // 4. the tile's output [A, B) in windows of kWin bytes from A's 16-byte
    //    line: every source writes its run's bytes into the staged window,
    //    then the block stores the window's whole lines, 16 bytes a thread.
    //    The line the window ends in waits for the next tile.
    const int Bc = min(B, out_len);
    for (int wa = A & ~15; wa < Bc; wa += kWin) {
      const int we = min(wa + kWin, Bc);
      if (tid < A - wa) s_o[tid] = s_pend[tid];
      int at = static_cast<int>(first >> 32);
      int sum = static_cast<int>(first & 0xFFFFFFFFLL) + carry;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const bool cnt = (cnt_mask >> j) & 1u;
        const int rep = j < nvalid ? (cnt ? b[j] : 1) : 0;
        const int src = cnt ? (j > 0 ? b[j - 1] : prev) : b[j];
        const int lo = max(at, wa), hi = min(at + rep, we);
        for (int p = lo; p < hi; ++p) {
          s_o[p - wa] = static_cast<uint8_t>(
              use_diff ? sum + (p - at + 1) * src : src);
        }
        at += rep;
        sum += rep * src;
      }
      __syncthreads();
      const int lines = (we - wa) >> 4;
      for (int q = tid; q < lines; q += kThreads) {
        *reinterpret_cast<uint4*>(o + wa + 16 * q) =
            *reinterpret_cast<const uint4*>(s_o + 16 * q);
      }
      if (tid < 16 && (we & 15)) {  // only the tile's last window
        const int k = 16 * lines + tid;
        s_pend[tid] = k < we - wa ? s_o[k] : 0;
      }
      __syncthreads();
    }
    if (B >= out_len) break;  // the rest of the row is past out_len
  }

  // the last partial group, then zeros to out_len
  const int total = min(static_cast<int>(run >> 32), out_len);
  int z = (total + 15) & ~15;
  if ((total & 15) && tid == 0) {
    unsigned w[4];
    const uint4 q = *reinterpret_cast<const uint4*>(s_pend);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    const int keep = total & 15;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k >= keep) w[k >> 2] &= ~(255u << (8 * (k & 3)));
    }
    *reinterpret_cast<uint4*>(o + (total & ~15)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int p = z + tid * 16; p < out_len; p += kThreads * 16) {
    *reinterpret_cast<uint4*>(o + p) = zero4;
  }
}

}  // namespace

extern "C" int rle_expand_launch(const void* streams, const void* lens,
                                 const void* carries, void* out, int C, int n,
                                 int out_len, int use_diff, void* stream) {
  const auto* x = static_cast<const uint8_t*>(streams);
  const auto* l = static_cast<const int*>(lens);
  const auto* car = static_cast<const uint8_t*>(carries);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (n <= 1024) {  // short rows (the adaptive decodes' small tiles)
    rle_expand_kernel<32><<<C, 32, 0, st>>>(x, l, car, o, n, out_len,
                                            use_diff);
  } else {
    rle_expand_kernel<256><<<C, 256, 0, st>>>(x, l, car, o, n, out_len,
                                              use_diff);
  }
  return static_cast<int>(cudaGetLastError());
}
