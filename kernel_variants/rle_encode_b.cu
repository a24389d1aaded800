// Design variant (b) of huffman_codec_tpu_torch/csrc/rle_encode.cu, kept so
// that its time can be measured again beside the package's kernel
// (kernel_variants/time_variants.py); the package never builds it.
// The contract and the bound are those of csrc/rle_encode.cu.
//
// Variant (b): bit masks a thread and one look-back over spans. -DRELAXED reads
// and writes the status words relaxed (no fence), -DHALO_GLOBAL takes the halo
// from global memory (L1) instead of a shared copy, -DTHREADS=t sets the
// block's threads, -DMINB=k the blocks an SM, and -DNO_ATOMIC (tile numbers
// from blockIdx), -DNO_STORE and -DNO_LOOKBACK drop a step (the last two:
// timing only, the output is then wrong).
//
// Design: one block per (chunk, 4096-byte tile), 16 bytes a thread, so a
// 256-chunk step is 4096 blocks in flight rather than 256 blocks walking
// 16 tiles each. A block takes its tile from an atomic counter in launch
// order, so it only ever waits on tiles whose blocks are already running.
// A thread reads its 16 bytes with one 16-byte load and takes the byte
// before and after them from its neighbours' words in shared memory; it
// diffs and compares four bytes at a time (__vsub4, __vcmpne4) into a
// 17-bit mask of segment starts, and from that mask alone, with shifts
// and popcounts, the masks of its literals and count bytes. A span of
// positions is summed up by its first and last segment start and the
// bytes its whole segments in between emit (a whole segment of m bytes
// emits 4 (m / 258) + min(m % 258, 3) + (m % 258 >= 3)); spans combine in
// order, so one block scan of the threads' spans and one decoupled
// look-back over the chunk's earlier tiles (one 64-bit status word a
// tile: its own span, then the span of the row up to its end) give every
// thread the last start before it and that start's output offset, which
// is all it needs: its first output offset, and the q of the positions
// before its own first start. The emitted bytes are staged in shared
// memory at their line phase and leave as aligned 16-byte stores; only
// the two partial lines at the ends of a tile's range, whose other bytes
// belong to its neighbours, are stored a byte at a time. The block of a
// chunk's last valid tile zero-fills the rest of the row the same way
// and writes its length; the tile-0 block of an empty row does that
// alone; blocks whose tile lies wholly past the length exit at once.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

#ifndef THREADS
#define THREADS 256
#endif
constexpr int kThreads = THREADS;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kReset = 258;
// a tile emits at most 4096 + 4096 / 3 + 4 bytes; staged at its line phase
// (up to 15) and read back in whole 16-byte lines
constexpr int kStage = (kTile + kTile / 3 + 4 + 15 + 15) / 16 * 16;

// The segment starts of a span of positions: the first (f, absolute; -1
// when the span has none) and the last (l), and s, the bytes emitted by
// the positions from f up to l (the whole segments between them). From
// position 0, s is the output offset of l's first byte.
struct Span {
  int f, l, s;
};

// bytes a whole segment of m positions emits
__device__ __forceinline__ int seg_total(int m) {
  const int k = m / kReset, r = m - k * kReset;
  return 4 * k + min(r, 3) + (r >= 3);
}

// bytes the first d positions of a segment emit when it goes on past them
__device__ __forceinline__ int seg_head(int d) {
  const int k = d / kReset, r = d - k * kReset;
  return 4 * k + min(r, 3);
}

struct SpanOp {  // a, then b
  __device__ __forceinline__ Span operator()(const Span& a,
                                             const Span& b) const {
    if (a.f < 0) return b;
    if (b.f < 0) return a;
    return Span{a.f, b.l, a.s + seg_total(b.f - a.l) + b.s};
  }
};

// status word of a tile: flag << 62, then
//   kAgg:  the tile's own span, f and l relative to the tile
//          (has << 61 | f << 48 | l << 35 | s);
//   kIncl: the span from position 0 to the tile's end (l << 31 | s).
constexpr uint64_t kAgg = 1;
constexpr uint64_t kIncl = 2;
constexpr uint64_t kField = (1ull << 31) - 1;

__device__ __forceinline__ uint64_t pack_agg(const Span& a, int tb) {
  return kAgg << 62 |
         (a.f < 0 ? 0
                  : 1ull << 61 | static_cast<uint64_t>(a.f - tb) << 48 |
                        static_cast<uint64_t>(a.l - tb) << 35 |
                        static_cast<uint64_t>(a.s));
}

__device__ __forceinline__ uint64_t pack_incl(const Span& a) {
  return kIncl << 62 | static_cast<uint64_t>(a.l) << 31 |
         static_cast<uint64_t>(a.s);
}

__device__ __forceinline__ Span unpack(uint64_t w, int tile_idx) {
  if (w >> 62 == kIncl) {
    return Span{0, static_cast<int>(w >> 31 & kField),
                static_cast<int>(w & kField)};
  }
  if (!(w >> 61 & 1)) return Span{-1, -1, 0};
  const int tb = tile_idx * kTile;
  return Span{tb + static_cast<int>(w >> 48 & 8191),
              tb + static_cast<int>(w >> 35 & 8191),
              static_cast<int>(w & ((1ull << 35) - 1))};
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
#ifdef RELAXED
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
#else
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
#endif
               : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
#ifdef RELAXED
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
#else
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
#endif
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Warp 0: the span of the chunk before tile t (status at the chunk's tile
// 0), from the earlier tiles' status words: their own spans, nearest
// last, back to the first one that covers the row from position 0. Lane
// k reads tile hi - k, 32 tiles a round, waiting on words not yet set.
__device__ Span look_back(const uint64_t* status, int t) {
  const int lane = threadIdx.x & 31;
  const SpanOp op;
  Span acc{-1, -1, 0};
  for (int hi = t - 1; hi >= 0; hi -= 32) {
    const int idx = hi - lane;
    uint64_t w;
    unsigned stop, need;
    for (unsigned spin = 0;; ++spin) {
      w = idx >= 0 ? ld_acquire(status + idx) : kIncl << 62;
      const uint64_t flag = w >> 62;
      stop = __ballot_sync(~0u, flag >= kIncl);
      const unsigned ready = __ballot_sync(~0u, flag >= kAgg);
      need = stop ? stop ^ (stop - 1) : ~0u;  // lanes up to the first stop
      if ((ready & need) == need) break;
      // the tiles waited on are running and publish within microseconds;
      // a wait of seconds is a fault, which ends the launch with an error
      if (spin == 1u << 26) __trap();
      __nanosleep(32);
    }
    Span v{-1, -1, 0};
    if ((need >> lane & 1) && idx >= 0) v = unpack(w, idx);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // lane + d holds the earlier tiles
      const Span o{__shfl_down_sync(~0u, v.f, d),
                   __shfl_down_sync(~0u, v.l, d),
                   __shfl_down_sync(~0u, v.s, d)};
      if (lane + d < 32) v = op(o, v);
    }
    v = Span{__shfl_sync(~0u, v.f, 0), __shfl_sync(~0u, v.l, 0),
             __shfl_sync(~0u, v.s, 0)};
    acc = op(v, acc);
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

// 4 bytes of __vcmpne4 (0xff where they differ) -> 4 bits
__device__ __forceinline__ uint32_t byte_bits(uint32_t r) {
  return ((r & 0x01010101u) * 0x01020408u) >> 24;
}

// bit j: position base + j (j = 0 .. 16) is a tile mode edge
__device__ __forceinline__ uint32_t edge_bits(int base, int tile) {
  if (tile >= 16) {
    return ((base & (tile - 1)) == 0 ? 1u : 0u) |
           (((base + 16) & (tile - 1)) == 0 ? 0x18000u : 0u);
  }
  return tile <= 2 ? 0x1ffffu : tile == 4 ? 0x19999u : 0x18181u;
}

#ifndef MINB
#define MINB 4
#endif
__global__ void __launch_bounds__(kThreads, MINB)
rle_encode_kernel(const uint8_t* __restrict__ chunks,
                  const int* __restrict__ lens,
                  const uint8_t* __restrict__ carries,
                  uint8_t* __restrict__ streams, int* __restrict__ out_lens,
                  uint64_t* scratch, int n, int cap, int nt, int use_diff,
                  int tile) {
  using Scan = cub::BlockScan<Span, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ __align__(16) uint8_t stage[kStage];
  // first[i]: thread i's first word, first[256] the word after the tile;
  // last[i + 1]: thread i's last word, last[0] the word before the tile
  __shared__ uint32_t first[kThreads + 1], last[kThreads + 1];
  __shared__ int sh_id, sh_lo, sh_end;
  __shared__ Span sh_before;

  if (threadIdx.x == 0) {
    // the tile counter follows the status words
#ifdef NO_ATOMIC
    sh_id = blockIdx.x;
#else
    sh_id = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(scratch + gridDim.x), 1u));
#endif
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
  const int base = tb + threadIdx.x * kItems;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (base < length) v = *reinterpret_cast<const uint4*>(x + base);
#ifdef HALO_GLOBAL
  uint32_t before = 0, after = 0;
  if (base < length) {
    const uint32_t carry = carries[c];
    before = base ? *reinterpret_cast<const uint32_t*>(x + base - 4) : carry << 24 | carry << 16;
    after = base + 16 < length ? *reinterpret_cast<const uint32_t*>(x + base + 16) : 0;
  }
#else
  first[threadIdx.x] = v.x;
  last[threadIdx.x + 1] = v.w;
  if (threadIdx.x == 0) {
    const uint32_t carry = carries[c];  // x[-1] (and x[-2]) at a row start
    last[0] = tb ? *reinterpret_cast<const uint32_t*>(x + tb - 4)
                 : carry << 24 | carry << 16;
    first[kThreads] = tb + kTile < length
                          ? *reinterpret_cast<const uint32_t*>(x + tb + kTile)
                          : 0;
  }
  __syncthreads();
  const uint32_t before = last[threadIdx.x];   // x[base - 4 .. base - 1]
  const uint32_t after = first[threadIdx.x + 1];  // x[base + 16 ..]
#endif

  // y four bytes a word; yb holds y[base - 1] in its top byte, ya
  // y[base + 16] in its low byte
  uint32_t y0 = v.x, y1 = v.y, y2 = v.z, y3 = v.w, yb = before, ya = after;
  if (use_diff) {
    y0 = __vsub4(v.x, __byte_perm(before, v.x, 0x6543));
    y1 = __vsub4(v.y, __byte_perm(v.x, v.y, 0x6543));
    y2 = __vsub4(v.z, __byte_perm(v.y, v.z, 0x6543));
    y3 = __vsub4(v.w, __byte_perm(v.z, v.w, 0x6543));
    yb = __vsub4(before, before << 8);
    ya = __vsub4(after, v.w >> 24);
  }
  // bit j: position base + j starts a segment (j = 0 .. 16)
  uint32_t start =
      byte_bits(__vcmpne4(y0, __byte_perm(yb, y0, 0x6543))) |
      byte_bits(__vcmpne4(y1, __byte_perm(y0, y1, 0x6543))) << 4 |
      byte_bits(__vcmpne4(y2, __byte_perm(y1, y2, 0x6543))) << 8 |
      byte_bits(__vcmpne4(y3, __byte_perm(y2, y3, 0x6543))) << 12 |
      static_cast<uint32_t>((ya & 255) != y3 >> 24) << 16;
  const int rel = length - 1 - base;  // the last valid position, relative
  if (base == 0) start |= 1;
  if (rel >= 0 && rel <= kItems) start |= 1u << rel;
  if (tile > 0) start |= edge_bits(base, tile);
  const int nv = min(max(length - base, 0), kItems + 1);
  start &= (1u << nv) - 1;
  const uint32_t valid = (1u << min(nv, kItems)) - 1;

  // literals and count bytes of the positions from the thread's first
  // start on: d, the distance to their segment's start, is at most 15
  const uint32_t own = start & 0xffffu;
  const int f = own ? __ffs(own) - 1 : kItems;  // before f: the head
  const uint32_t d1 = own << 1 & ~own;          // d == 1
  const uint32_t d2 = own << 2 & ~own & ~(own << 1);  // d == 2
  uint32_t seg_end = start >> 1;
  if (rel >= 0 && rel < kItems) seg_end |= 1u << rel;
  const uint32_t tail = 0xffffu & ~((1u << f) - 1);
  uint32_t lit = (own | d1 | d2) & valid;
  uint32_t cnt = seg_end & ~(own | d1) & tail & valid;

  Span mine{-1, -1, 0};
  if (own) {
    const int lp = 31 - __clz(own);
    const uint32_t between = ((1u << lp) - 1) & tail;
    mine = Span{base + f, base + lp,
                __popc(lit & between) + __popc(cnt & between)};
  }
  Span pre, agg;
  Scan(scan_tmp).ExclusiveScan(mine, pre, Span{-1, -1, 0}, SpanOp(), agg);
  if (threadIdx.x < 32) {
    Span bt{-1, -1, 0};
    if (t == 0) {
      if (threadIdx.x == 0) st_release(status, pack_incl(agg));
    } else {
      if (threadIdx.x == 0) st_release(status + t, pack_agg(agg, tb));
#ifdef NO_LOOKBACK
      bt = Span{0, tb - 1, tb + tb / 3};
#else
      bt = look_back(status, t);
#endif
      if (threadIdx.x == 0) st_release(status + t, pack_incl(SpanOp()(bt, agg)));
    }
    if (threadIdx.x == 0) sh_before = bt;
  }
  __syncthreads();
  const Span tile_before = sh_before;

  // the last start before this thread gives its first output offset and
  // the q of its head (the positions before its first start)
  const Span at = SpanOp()(tile_before, pre);
  int off = 0, q0 = 0;
  if (at.f >= 0) {
    const int d = base - at.l;
    off = at.s + ((start & 1) ? seg_total(d) : seg_head(d));
    q0 = d % kReset;
  }
  if (f > 0) {
    const uint32_t head = ((1u << f) - 1) & valid;
    uint32_t hl = q0 < 3 ? (1u << (3 - q0)) - 1
                         : (kReset - q0 < kItems ? 7u << (kReset - q0) : 0);
    uint32_t hc = kReset - 1 - q0 < kItems ? 1u << (kReset - 1 - q0) : 0;
    if ((seg_end >> (f - 1) & 1) && (q0 + f - 1) % kReset >= 2) {
      hc |= 1u << (f - 1);
    }
    lit |= hl & head;
    cnt |= hc & head;
  }
  if (threadIdx.x == 0) sh_lo = off;
  if (threadIdx.x == kThreads - 1) sh_end = off + __popc(lit) + __popc(cnt);
  __syncthreads();
  const int lo_rel = sh_lo;
  const size_t lo = row + lo_rel;  // where this tile's bytes go

  // stage the emitted bytes at their line phase
  if (lit | cnt) {
    int o = static_cast<int>(lo & 15) + off - lo_rel;
    const uint32_t ys[4] = {y0, y1, y2, y3};
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((lit >> j & 1) && o < kStage) {
        stage[o++] = static_cast<uint8_t>(ys[j >> 2] >> (8 * (j & 3)));
      }
      if ((cnt >> j & 1) && o < kStage) {
        int q;
        if (j < f) {
          q = q0 + j >= kReset ? q0 + j - kReset : q0 + j;
        } else {
          q = j - (31 - __clz(own & ((2u << j) - 1)));
        }
        stage[o++] = static_cast<uint8_t>(q - 2);
      }
    }
  }
  __syncthreads();

  const bool last_tile = tb + kTile >= length;
  // the row's last start is at length - 1, and emits one literal
  const int end_rel =
      last_tile ? SpanOp()(tile_before, agg).s + 1 : sh_end;
  const size_t row_end = row + cap;
  const size_t data_end = row + end_rel;
  const size_t hi =
      last_tile ? row_end : (data_end < row_end ? data_end : row_end);
#ifndef NO_STORE
  store_range(streams, stage, lo < row_end ? lo : row_end, hi, data_end);
#endif
  if (last_tile && threadIdx.x == 0) out_lens[c] = end_rel;
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
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, (blocks + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  rle_encode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(chunks), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(carries), static_cast<uint8_t*>(streams),
      static_cast<int*>(out_lens), static_cast<uint64_t*>(scratch), n, cap,
      nt, use_diff, tile);
  return static_cast<int>(cudaGetLastError());
}
