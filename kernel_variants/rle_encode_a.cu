// Design variant (a) of huffman_codec_tpu_torch/csrc/rle_encode.cu, kept so
// that its time can be measured again beside the package's kernel
// (kernel_variants/time_variants.py); the package never builds it.
// The contract and the bound are those of csrc/rle_encode.cu.
//
// Variant (a): the first design: a block a 4096-byte tile, 16 bytes a thread,
// two look-backs (the max of segment starts, then the sum of emissions) and
// per-position loops. -DNO_LOOKBACK and -DNO_COMPUTE drop the look-back or the
// per-position work (timing only: the output is then wrong); -DMINB=k sets the
// blocks an SM of __launch_bounds__.
//
// Design: one block per (chunk, 4096-byte tile), 16 bytes a thread, so a
// 256-chunk step is 4096 blocks in flight rather than 256 blocks walking
// 16 tiles each. A block takes its tile from an atomic counter in launch
// order, so it only ever waits on tiles whose blocks are already running.
// The tile's segment starts need only its bytes and a 3-byte halo (read
// from a shared copy of the tile); the origin of a position is the max of
// all starts before it and its output offset the sum of all emissions
// before it, and both cross tiles through a single-pass decoupled
// look-back over the chunk's earlier tiles: one 64-bit status word a tile
// holds a flag, a max field and a sum field. A tile publishes its own max
// of starts (flag 1), then, once the look-back gave it the origin it
// enters with, its max including everything before it and its own
// emission count (flag 2), then its sum including everything before it
// (flag 3); a look-back adds up aggregates until it reaches an inclusive
// word. The emitted bytes are staged in shared memory at their line
// phase and leave as aligned 16-byte stores; only the two partial lines at
// the ends of a tile's range, whose other bytes belong to its neighbours,
// are stored a byte at a time. The block of a chunk's last valid tile
// zero-fills the rest of the row the same way and writes its length; the
// tile-0 block of an empty row does that alone; blocks whose tile lies
// wholly past the length exit at once.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kReset = 258;
// a tile emits at most 4096 + 4096 / 3 + 4 bytes; staged at its line phase
// (up to 15) and read back in whole 16-byte lines
constexpr int kStage = 5504;

// status word: flag << 62 | max << 31 | sum, both fields below 2^31
constexpr uint64_t kMaxAgg = 1;   // max: the tile's own starts
constexpr uint64_t kMaxIncl = 2;  // max: inclusive; sum: the tile's own
constexpr uint64_t kSumIncl = 3;  // max and sum: inclusive
constexpr uint64_t kField = (1ull << 31) - 1;

__device__ __forceinline__ uint64_t pack(uint64_t flag, uint32_t mx,
                                         uint32_t sum) {
  return flag << 62 | static_cast<uint64_t>(mx) << 31 | sum;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

// Warp 0's look-back over tiles t - 1, t - 2, ... of one chunk (status at
// the chunk's tile 0): combines the max (kSum false) or the sum field of
// words flagged `agg` until a word flagged `incl` or more, waiting on
// words not yet flagged `agg`. Lane k reads tile hi - k, 32 tiles a round.
template <bool kSum>
__device__ int look_back(const uint64_t* status, int t, uint64_t agg,
                         uint64_t incl) {
  const int lane = threadIdx.x & 31;
  int acc = 0;
  for (int hi = t - 1; hi >= 0; hi -= 32) {
    const int idx = hi - lane;
    uint64_t w;
    unsigned stop, need;
    for (unsigned spin = 0;; ++spin) {
      w = idx >= 0 ? ld_acquire(status + idx) : pack(incl, 0, 0);
      const uint64_t f = w >> 62;
      stop = __ballot_sync(~0u, f >= incl);
      const unsigned ready = __ballot_sync(~0u, f >= agg);
      need = stop ? stop ^ (stop - 1) : ~0u;  // lanes up to the first stop
      if ((ready & need) == need) break;
      // the tiles waited on are running and publish within microseconds;
      // a wait of seconds is a fault, which ends the launch with an error
      if (spin == 1u << 26) __trap();
      __nanosleep(32);
    }
    int v = (need >> lane) & 1
                ? static_cast<int>(kSum ? w & kField : (w >> 31) & kField)
                : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const int u = __shfl_xor_sync(~0u, v, o);
      v = kSum ? v + u : max(v, u);
    }
    acc = kSum ? acc + v : max(acc, v);
    if (stop) break;
  }
  return acc;
}

// Store bytes [lo, hi) of the streams buffer (absolute offsets): those
// below data_end from the stage (stage[0] is the byte at lo & ~15), the
// rest zero. Whole lines as 16-byte stores, partial lines byte by byte.
__device__ void store_range(uint8_t* __restrict__ streams,
                            const uint8_t* stage, size_t lo, size_t hi,
                            size_t data_end) {
  if (lo >= hi) return;
  const size_t s0 = lo & ~static_cast<size_t>(15);
  for (size_t a = s0 + 16 * threadIdx.x; a < hi; a += 16 * kThreads) {
    if (a >= lo && a + 16 <= hi) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (a + 16 <= data_end) {
        v = *reinterpret_cast<const uint4*>(stage + (a - s0));
      } else if (a < data_end) {
        uint32_t w[4] = {0, 0, 0, 0};
        for (int b = 0; a + b < data_end; ++b) {
          w[b >> 2] |= static_cast<uint32_t>(stage[a - s0 + b]) << (8 * (b & 3));
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(streams + a) = v;
    } else {
      const size_t b0 = a > lo ? a : lo;
      const size_t b1 = a + 16 < hi ? a + 16 : hi;
      for (size_t b = b0; b < b1; ++b) {
        streams[b] = b < data_end ? stage[b - s0] : 0;
      }
    }
  }
}

#ifndef MINB
#define MINB 4
#endif
__global__ void __launch_bounds__(kThreads, MINB)
rle_encode_kernel(const uint8_t* __restrict__ chunks,
                  const int* __restrict__ lens,
                  const uint8_t* __restrict__ carries,
                  uint8_t* __restrict__ streams, int* __restrict__ out_lens,
                  uint64_t* scratch, int n, int cap, int nt,
                  int use_diff, int tile) {
  using Scan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  // the tile at xs[16 .. 16 + kTile), x[tb - 2] and x[tb - 1] before it,
  // x[tb + kTile] after it
  __shared__ __align__(16) uint8_t xs[kTile + 32];
  __shared__ __align__(16) uint8_t stage[kStage];
  __shared__ int sh_id, sh_max, sh_sum;

  if (threadIdx.x == 0) {
    // the tile counter follows the status words
    sh_id = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(scratch + gridDim.x), 1u));
  }
  __syncthreads();
  const int c = sh_id / nt;
  const int t = sh_id - c * nt;
  const int tb = t * kTile;
  const int length = min(max(lens[c], 0), n);
  if (tb >= length && t > 0) return;  // wholly past the length
  uint64_t* status = scratch + static_cast<size_t>(c) * nt;
  const size_t row = static_cast<size_t>(c) * cap;
  if (length == 0) {  // an empty row: zeros and length 0
    store_range(streams, stage, row, row + cap, row);
    if (threadIdx.x == 0) out_lens[c] = 0;
    return;
  }

  const uint8_t* x = chunks + static_cast<size_t>(c) * n;
  const int carry = carries[c];
  const int base = tb + threadIdx.x * kItems;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (base < length) v = *reinterpret_cast<const uint4*>(x + base);
  *reinterpret_cast<uint4*>(xs + 16 + threadIdx.x * kItems) = v;
  if (threadIdx.x == 0) {
    xs[14] = tb >= 2 ? x[tb - 2] : carry;
    xs[15] = tb >= 1 ? x[tb - 1] : carry;
    xs[16 + kTile] = tb + kTile < length ? x[tb + kTile] : 0;
  }
  __syncthreads();

  // y at position base - 1 + k, from the shared copy (x[-1] is the carry)
  auto y_at = [&](int k) {
    const int p = 16 + threadIdx.x * kItems - 1 + k;
    const int xv = xs[p];
    return use_diff ? (xv - xs[p - 1]) & 255 : xv;
  };
  const int tmask = tile - 1;  // -1 when tile == 0, and then unused
  // bit j: position base + j starts a segment (j = 0 .. 16)
  unsigned start = 0;
  {
    int prev = y_at(0);
#pragma unroll
    for (int j = 0; j <= kItems; ++j) {
      const int i = base + j;
      const int cur = y_at(j + 1);
      const int ti = i & tmask;
      const bool edge = tile > 0 && (ti == 0 || ti == tmask);
      const bool s = i < length &&
                     (i == 0 || cur != prev || i == length - 1 || edge);
      start |= static_cast<unsigned>(s) << j;
      prev = cur;
    }
  }
#ifdef NO_COMPUTE
  start = 0xFFFFFFFFu;
#endif
  const unsigned own = start & 0xFFFFu;
  const int tmax = own ? base + 31 - __clz(own) : 0;
  int tpre, agg_max;
  Scan(scan_tmp).ExclusiveScan(tmax, tpre, 0, MaxOp(), agg_max);
  if (threadIdx.x == 0) st_release(status + t, pack(kMaxAgg, agg_max, 0));
  if (threadIdx.x < 32) {
#ifdef NO_LOOKBACK
    const int ex = 0;
#else
    const int ex = t > 0 ? look_back<false>(status, t, kMaxAgg, kMaxIncl) : 0;
#endif
    if (threadIdx.x == 0) sh_max = ex;
  }
  __syncthreads();
  const int ex_max = sh_max;
  const int incl_max = max(ex_max, agg_max);

  // emissions: q walks from the origin this thread enters with
  const int origin = max(ex_max, tpre);
  const int q0 = (own & 1) ? 0 : (base - origin) % kReset;
  unsigned emit = 0;  // 2 bits a position: literal, count byte
  int cnt = 0;
  {
    int q = q0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j;
      if (j > 0) q = (start >> j & 1) ? 0 : (q + 1 == kReset ? 0 : q + 1);
      const bool seg_end = i == length - 1 || (start >> (j + 1) & 1);
      const bool lit = i < length && q < 3;
      const bool cb = i < length && (q == kReset - 1 || (seg_end && q >= 2));
      emit |= (static_cast<unsigned>(lit) | static_cast<unsigned>(cb) << 1)
              << (2 * j);
      cnt += lit + cb;
    }
  }
  int toff, agg_sum;
  Scan(scan_tmp).ExclusiveSum(cnt, toff, agg_sum);
  if (t == 0) {
    if (threadIdx.x == 0) {
      st_release(status, pack(kSumIncl, incl_max, agg_sum));
      sh_sum = 0;
    }
  } else if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      st_release(status + t, pack(kMaxIncl, incl_max, agg_sum));
    }
#ifdef NO_LOOKBACK
    const int ex = t * 4100;
#else
    const int ex = look_back<true>(status, t, kMaxIncl, kSumIncl);
#endif
    if (threadIdx.x == 0) {
      st_release(status + t, pack(kSumIncl, incl_max, ex + agg_sum));
      sh_sum = ex;
    }
  }
  __syncthreads();
  const size_t lo = row + sh_sum;  // where this tile's bytes go
  const int phase = static_cast<int>(lo & 15);

  // stage the emitted bytes at their line phase
  if (emit) {
    int o = phase + toff;
    int q = q0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j > 0) q = (start >> j & 1) ? 0 : (q + 1 == kReset ? 0 : q + 1);
      const unsigned e = emit >> (2 * j) & 3;
      if ((e & 1) && o < kStage) stage[o++] = static_cast<uint8_t>(y_at(j + 1));
      if ((e & 2) && o < kStage) stage[o++] = static_cast<uint8_t>(q - 2);
    }
  }
  __syncthreads();

  const bool last = tb + kTile >= length;
  const size_t row_end = row + cap;
  const size_t data_end = lo + agg_sum;
  const size_t hi = last ? row_end : (data_end < row_end ? data_end : row_end);
  store_range(streams, stage, lo < row_end ? lo : row_end, hi, data_end);
  if (last && threadIdx.x == 0) out_lens[c] = sh_sum + agg_sum;
}

}  // namespace

extern "C" int rle_encode_launch(const void* chunks, const void* lens,
                                 const void* carries, void* streams,
                                 void* out_lens, void* scratch, int C, int n,
                                 int cap, int use_diff, int tile,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = n > 0 ? (n + kTile - 1) / kTile : 1;
  const size_t blocks = static_cast<size_t>(C) * nt;
  // a status word a tile, then the tile counter
  cudaError_t err = cudaMemsetAsync(scratch, 0, (blocks + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  rle_encode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(chunks), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(carries), static_cast<uint8_t*>(streams),
      static_cast<int*>(out_lens), static_cast<uint64_t*>(scratch), n, cap,
      nt, use_diff, tile);
  return static_cast<int>(cudaGetLastError());
}
