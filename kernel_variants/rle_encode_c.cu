// Design variant (c) of huffman_codec_tpu_torch/csrc/rle_encode.cu, kept so
// that its time can be measured again beside the package's kernel
// (kernel_variants/time_variants.py); the package never builds it.
// The contract and the bound are those of csrc/rle_encode.cu.
//
// Variant (c): the span found by two int block scans, SWAR byte arithmetic,
// relaxed status words, the halo from L1, 32-bit store offsets. -DMINB=k sets
// the blocks an SM of __launch_bounds__.
//
// Design: one block per (chunk, 4096-byte tile), 16 bytes a thread, so a
// 256-chunk step is 4096 blocks in flight rather than 256 blocks walking
// 16 tiles each. A block takes its tile from an atomic counter in launch
// order, so it only ever waits on tiles whose blocks are already running.
// A thread reads its 16 bytes with one 16-byte load and the 4 bytes before
// and after them with two 4-byte loads (its neighbours' bytes, which hit
// L1); it diffs and compares four bytes to a word (SWAR) into a 17-bit mask
// of segment starts, and from that mask alone, with shifts and popcounts,
// the masks of its literals and count bytes. A span of positions is summed
// up by its first and last segment start and the bytes its whole segments
// in between emit (a whole segment of m bytes emits 4 (m / 258) +
// min(m % 258, 3) + (m % 258 >= 3)). Inside a tile two int block scans (the
// last start before each thread, then the bytes emitted from the tile's
// first start up to it) give the tile's span; spans combine in order, so
// one decoupled look-back over the chunk's earlier tiles (one 64-bit status
// word a tile: its own span, then the span of the row up to its end) gives
// every thread the last start before it and that start's output offset,
// which is all it needs: its first output offset, and the q of the
// positions before its own first start. The emitted bytes are staged in
// shared memory at their line phase and leave as aligned 16-byte stores;
// only the two partial lines at the ends of a tile's range, whose other
// bytes belong to its neighbours, are stored a byte at a time. The block
// of a chunk's last valid tile zero-fills the rest of the row the same way
// and writes its length; the tile-0 block of an empty row does that alone;
// blocks whose tile lies wholly past the length exit at once.

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

// The status word carries everything a reader needs, so no other memory
// is ordered by it: relaxed single-copy-atomic accesses at device scope.
__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
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
      w = idx >= 0 ? ld_relaxed(status + idx) : kIncl << 62;
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

// Store bytes [lo, hi) of a row, counted from the 16-byte aligned address
// ab: those below data_end from the stage (stage[0] is the byte at lo &
// ~15), the rest zero. Whole lines as 16-byte stores, partial lines (whose
// other bytes belong to a neighbouring tile or row) byte by byte.
__device__ void store_range(uint8_t* ab, const uint8_t* stage, int lo,
                            int hi, int data_end) {
  if (lo >= hi) return;
  const int s0 = lo & ~15;
  for (int a = s0 + 16 * threadIdx.x; a < hi; a += 16 * kThreads) {
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
      *reinterpret_cast<uint4*>(ab + a) = v;
    } else {
      const int b1 = min(a + 16, hi);
      for (int b = max(a, lo); b < b1; ++b) {
        ab[b] = b < data_end ? stage[b - s0] : 0;
      }
    }
  }
}

// bytewise a - b (mod 256)
__device__ __forceinline__ uint32_t sub_bytes(uint32_t a, uint32_t b) {
  return ((a | 0x80808080u) - (b & 0x7f7f7f7fu)) ^ ((a ^ ~b) & 0x80808080u);
}

// bit k set where byte k of a differs from byte k of b
__device__ __forceinline__ uint32_t ne_bits(uint32_t a, uint32_t b) {
  const uint32_t t = a ^ b;
  const uint32_t nz = ((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t;
  return ((nz >> 7 & 0x01010101u) * 0x01020408u) >> 24;
}

// bit j: position base + j (j = 0 .. 16) is a tile mode edge
__device__ __forceinline__ uint32_t edge_bits(int base, int tile) {
  if (tile >= 16) {
    return ((base & (tile - 1)) == 0 ? 1u : 0u) |
           (((base + 16) & (tile - 1)) == 0 ? 0x18000u : 0u);
  }
  return tile <= 2 ? 0x1ffffu : tile == 4 ? 0x19999u : 0x18181u;
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

#ifndef MINB
#define MINB 8
#endif
__global__ void __launch_bounds__(kThreads, MINB)
rle_encode_kernel(const uint8_t* __restrict__ chunks,
                  const int* __restrict__ lens,
                  const uint8_t* __restrict__ carries,
                  uint8_t* __restrict__ streams, int* __restrict__ out_lens,
                  uint64_t* scratch, int n, int cap, int nt, int use_diff,
                  int tile) {
  using Scan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_max, scan_sum;
  __shared__ __align__(16) uint8_t stage[kStage];
  __shared__ int sh_c, sh_t, sh_first, sh_lo, sh_end;
  __shared__ Span sh_before;

  if (threadIdx.x == 0) {
    // the tile counter follows the status words
    const int id = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(scratch + gridDim.x), 1u));
    sh_c = id / nt;
    sh_t = id - sh_c * nt;
    sh_first = -1;
  }
  __syncthreads();
  const int c = sh_c;
  const int t = sh_t;
  const int tb = t * kTile;
  const int length = min(max(lens[c], 0), n);
  if (tb >= length && t > 0) return;  // wholly past the length
  uint64_t* status = scratch + static_cast<size_t>(c) * nt;
  // the row's bytes counted from the 16-byte line its first byte is in
  uint8_t* const rp = streams + static_cast<size_t>(c) * cap;
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(rp) & 15);
  uint8_t* const ab = rp - phase;
  if (length == 0) {  // an empty row: zeros and length 0
    store_range(ab, stage, phase, phase + cap, phase);
    if (threadIdx.x == 0) out_lens[c] = 0;
    return;
  }

  // the thread's 16 bytes, and the 4 before and after them (neighbours'
  // bytes, just loaded by them: L1 hits); x[-1] and x[-2] are the carry
  const uint8_t* x = chunks + static_cast<size_t>(c) * n;
  const int base = tb + threadIdx.x * kItems;
  uint4 v = make_uint4(0, 0, 0, 0);
  uint32_t before = 0, after = 0;
  if (base < length) {
    v = *reinterpret_cast<const uint4*>(x + base);
    before = base ? *reinterpret_cast<const uint32_t*>(x + base - 4)
                  : carries[c] * 0x01010000u;
    after = base + kItems < length
                ? *reinterpret_cast<const uint32_t*>(x + base + kItems)
                : 0;
  }
  // y four bytes a word; yb holds y[base - 1] in its top byte, ya
  // y[base + 16] in its low byte
  uint32_t y0 = v.x, y1 = v.y, y2 = v.z, y3 = v.w, yb = before, ya = after;
  if (use_diff) {
    y0 = sub_bytes(v.x, __byte_perm(before, v.x, 0x6543));
    y1 = sub_bytes(v.y, __byte_perm(v.x, v.y, 0x6543));
    y2 = sub_bytes(v.z, __byte_perm(v.y, v.z, 0x6543));
    y3 = sub_bytes(v.w, __byte_perm(v.z, v.w, 0x6543));
    yb = sub_bytes(before, before << 8);
    ya = sub_bytes(after, v.w >> 24);
  }
  // bit j: position base + j starts a segment (j = 0 .. 16)
  uint32_t start = ne_bits(y0, __byte_perm(yb, y0, 0x6543)) |
                   ne_bits(y1, __byte_perm(y0, y1, 0x6543)) << 4 |
                   ne_bits(y2, __byte_perm(y1, y2, 0x6543)) << 8 |
                   ne_bits(y3, __byte_perm(y2, y3, 0x6543)) << 12 |
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

  // the tile's span by two int scans: the last start before each thread
  // (max), then the bytes emitted from the tile's first start up to it
  // (sum of each thread's span plus the segment that ends at its first
  // start)
  const int lp = own ? 31 - __clz(own) : 0;
  int lx, lmax;
  Scan(scan_max).ExclusiveScan(own ? base + lp : -1, lx, -1, MaxOp(), lmax);
  int w = 0;
  if (own) {
    const uint32_t between = ((1u << lp) - 1) & tail;
    w = __popc(lit & between) + __popc(cnt & between);
    if (lx >= 0) {
      w += seg_total(base + f - lx);
    } else {
      sh_first = base + f;  // the tile's first start
    }
  }
  int wx, wsum;
  Scan(scan_sum).ExclusiveSum(w, wx, wsum);
  __syncthreads();  // sh_first
  const Span agg =
      lmax >= 0 ? Span{sh_first, lmax, wsum} : Span{-1, -1, 0};
  if (threadIdx.x < 32) {
    Span bt{-1, -1, 0};
    if (t == 0) {
      if (threadIdx.x == 0) st_relaxed(status, pack_incl(agg));
    } else {
      if (threadIdx.x == 0) st_relaxed(status + t, pack_agg(agg, tb));
      bt = look_back(status, t);
      if (threadIdx.x == 0) {
        st_relaxed(status + t, pack_incl(SpanOp()(bt, agg)));
      }
    }
    if (threadIdx.x == 0) sh_before = bt;
  }
  __syncthreads();
  const Span tile_before = sh_before;

  // the last start before this thread gives its first output offset and
  // the q of its head (the positions before its first start)
  const Span at = SpanOp()(
      tile_before, lx >= 0 ? Span{sh_first, lx, wx} : Span{-1, -1, 0});
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
  const int lo = phase + sh_lo;  // where this tile's bytes go

  // stage the emitted bytes at their line phase
  if (lit | cnt) {
    int o = (lo & 15) + off - sh_lo;
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
  const int end_rel = last_tile ? SpanOp()(tile_before, agg).s + 1 : sh_end;
  const int row_end = phase + cap;
  const int data_end = phase + end_rel;
  const int hi = last_tile ? row_end : min(data_end, row_end);
  store_range(ab, stage, min(lo, row_end), hi, data_end);
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
