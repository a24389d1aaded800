// The first design of the FGK kernels, before the one-thread chain of
// csrc/fgk.cu, kept for kernel_variants/time_fgk_variants.py and for
// chip_smoke.py's FGK stress pass, which hold the package's kernels to it:
// a warp a chunk, lane 0 on the serial chain, the successor found by the
// whole warp at every tree level.
// Never built by the package. The same C entry points and contracts as
// csrc/fgk.cu.
//
// Tree: the slot form of the JAX package. Slot k holds node number 512 - k,
// the root is slot 0, new nodes append; a swap exchanges the contents of two
// slots (children, weight, symbol) while the positions keep their parents.
// After a symbol, from its leaf up to the root, a node is swapped with the
// lowest slot in [0..k] of its weight unless that slot is k or k's parent,
// and its weight goes up by one; the root's goes up last. A first
// occurrence first splits the NYT node into a new NYT (left) and the
// symbol's leaf (right), and is coded as the NYT node's code followed by the
// symbol's 8 bits.
//
// fgk_encode: chunks (C, L) u8, lengths (C,) i32 -> words (C, n_words) u32,
// the codes MSB-first (bit p is bit 31 - p % 32 of word p / 32), zero past
// the stream, words past n_words dropped; bits (C,) i32, the stream's bits.
// fgk_decode: words (C, W) u32, counts (C,) i32 -> out (C, out_len) u8, the
// first counts[c] symbols, zero past them; a read past a row reads its last
// word.
//
// Bound on the H100: the serial chain of the longest chunk. Each symbol is
// one climb of the tree (encode: the code; decode: the root-to-leaf walk)
// and one climb of the update, every level a few dependent shared-memory
// accesses; the bytes moved are far below that.
// Design: one warp per chunk, its tree in shared memory (514 slots of
// parent, left, right, symbol and weight, the 256 symbol slots; 12 KB).
// The successor search is the only step with parallel work: each lane
// reads four weights a pass with one 16-byte load (at most five passes
// cover the slots up to k) and a warp minimum picks the lowest match. Lane 0
// does the swap, the climbs and the bit I/O: the encoder appends each code
// to a 64-bit accumulator and stores a word when 32 bits are full, the
// decoder keeps two words of the stream in registers and loads the next
// while it decodes the current one. Symbols go through a 1 KB stage in
// shared memory, loaded and stored by the whole warp.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 514;   // 513 live slots and the spare one
constexpr int kDump = 513;    // takes the parent writes of absent children
constexpr int kFreqPad = 640; // weights in five passes of 128 slots
constexpr int kStage = 1024;  // symbols staged in shared memory at a time
constexpr unsigned kFull = 0xffffffffu;

struct Tree {
  alignas(16) int freq[kFreqPad];
  int parent[kSlots];
  int left[kSlots];
  int right[kSlots];
  int symbol[kSlots];
  int symslot[256];
  int nyt;
};

__device__ void tree_init(Tree& t, int lane) {
  for (int i = lane; i < kFreqPad; i += 32) t.freq[i] = 0;
  for (int i = lane; i < kSlots; i += 32) {
    t.parent[i] = -1;
    t.left[i] = -1;
    t.right[i] = -1;
    t.symbol[i] = 0;
  }
  for (int i = lane; i < 256; i += 32) t.symslot[i] = -1;
  if (lane == 0) t.nyt = 0;
  __syncwarp();
}

// The lowest slot s <= k with freq[s] == f (k itself qualifies).
__device__ __forceinline__ int lowest_equal(const Tree& t, int k, int f,
                                            int lane) {
  int best = INT_MAX;
#pragma unroll
  for (int p = 0; p < kFreqPad / 128; ++p) {
    if (p * 128 <= k) {  // the same for every lane
      const int base = p * 128 + lane * 4;
      const int4 v = *reinterpret_cast<const int4*>(&t.freq[base]);
      int hit = INT_MAX;
      if (v.w == f && base + 3 <= k) hit = base + 3;
      if (v.z == f && base + 2 <= k) hit = base + 2;
      if (v.y == f && base + 1 <= k) hit = base + 1;
      if (v.x == f && base <= k) hit = base;
      best = min(best, hit);
    }
  }
  return __reduce_min_sync(kFull, best);
}

// Lane 0 only.
__device__ void swap_slots(Tree& t, int a, int b) {
  int v;
  v = t.left[a]; t.left[a] = t.left[b]; t.left[b] = v;
  v = t.right[a]; t.right[a] = t.right[b]; t.right[b] = v;
  v = t.freq[a]; t.freq[a] = t.freq[b]; t.freq[b] = v;
  v = t.symbol[a]; t.symbol[a] = t.symbol[b]; t.symbol[b] = v;
  const int ab[2] = {a, b};
  for (int x : ab) {
    const int lc = t.left[x], rc = t.right[x];
    t.parent[lc >= 0 ? lc : kDump] = x;
    t.parent[rc >= 0 ? rc : kDump] = x;
  }
  for (int x : ab)
    if (t.left[x] < 0) t.symslot[t.symbol[x]] = x;
}

// The update after `sym` (read by lane 0 only); every lane calls it.
__device__ void tree_update(Tree& t, int sym, int lane) {
  int k = 0;
  if (lane == 0) {
    k = t.symslot[sym];
    if (k < 0) {  // first occurrence: split the NYT node
      const int old = t.nyt, leaf = old + 1, nyt = old + 2;
      t.left[old] = nyt;
      t.right[old] = leaf;
      t.left[leaf] = -1;
      t.right[leaf] = -1;
      t.left[nyt] = -1;
      t.right[nyt] = -1;
      t.parent[leaf] = old;
      t.parent[nyt] = old;
      t.freq[leaf] = 0;
      t.freq[nyt] = 0;
      t.symbol[leaf] = sym;
      t.symslot[sym] = leaf;
      t.nyt = nyt;
      k = leaf;
    }
  }
  __syncwarp();
  k = __shfl_sync(kFull, k, 0);
  for (;;) {
    const int pk = t.parent[k];
    if (pk < 0) break;
    const int succ = lowest_equal(t, k, t.freq[k], lane);
    const bool swap = succ != k && succ != pk;
    if (lane == 0) {
      if (swap) swap_slots(t, k, succ);
      t.freq[swap ? succ : k] += 1;
    }
    __syncwarp();
    // the swap leaves the parents of k and succ where they were
    k = t.parent[swap ? succ : k];
  }
  if (lane == 0) t.freq[0] += 1;
  __syncwarp();
}

__global__ void __launch_bounds__(32)
fgk_encode_kernel(const uint8_t* __restrict__ chunks,
                  const int* __restrict__ lengths, uint32_t* __restrict__ words,
                  int* __restrict__ bits, int L, int n_words) {
  __shared__ Tree t;
  __shared__ uint8_t stage[kStage];
  const int lane = threadIdx.x;
  const size_t c = blockIdx.x;
  const uint8_t* in = chunks + c * L;
  uint32_t* out = words + c * n_words;
  const int len = min(max(lengths[c], 0), L);
  tree_init(t, lane);

  uint64_t acc = 0;  // lane 0: nacc < 32 pending bits, right-aligned
  int nacc = 0;
  long long wi = 0, total = 0;
  auto put = [&](uint32_t v, int n) {  // n in [0, 32]
    if (n == 0) return;
    acc = (acc << n) | v;
    nacc += n;
    if (nacc >= 32) {
      nacc -= 32;
      if (wi < n_words) out[wi] = static_cast<uint32_t>(acc >> nacc);
      ++wi;
      acc &= (1ull << nacc) - 1;
    }
  };

  for (int s0 = 0; s0 < len; s0 += kStage) {
    const int n = min(kStage, len - s0);
    for (int i = lane; i < n; i += 32) stage[i] = in[s0 + i];
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      const int sym = stage[i];
      if (lane == 0) {
        const int k0 = t.symslot[sym];
        int k = k0 < 0 ? t.nyt : k0;
        uint64_t code = 0;  // bit d: the edge d levels above the leaf
        int d = 0;
        for (int p = t.parent[k]; p >= 0; k = p, p = t.parent[k]) {
          code |= static_cast<uint64_t>(t.left[p] != k) << min(d, 63);
          ++d;
        }
        if (d > 32) {
          put(static_cast<uint32_t>(code >> 32), d - 32);
          put(static_cast<uint32_t>(code), 32);
        } else {
          put(static_cast<uint32_t>(code), d);
        }
        total += d;
        if (k0 < 0) {  // a fresh symbol's 8 raw bits
          put(static_cast<uint32_t>(sym), 8);
          total += 8;
        }
      }
      tree_update(t, sym, lane);
    }
    __syncwarp();  // the stage is read before the next block refills it
  }
  if (lane == 0) {
    if (nacc > 0) {
      if (wi < n_words) out[wi] = static_cast<uint32_t>(acc << (32 - nacc));
      ++wi;
    }
    bits[c] = static_cast<int>(total);
  }
  const long long end = __shfl_sync(kFull, wi, 0);
  for (long long j = end + lane; j < n_words; j += 32) out[j] = 0;
}

__global__ void __launch_bounds__(32)
fgk_decode_kernel(const uint32_t* __restrict__ words,
                  const int* __restrict__ counts, uint8_t* __restrict__ out,
                  int W, int out_len) {
  __shared__ Tree t;
  __shared__ uint8_t stage[kStage];
  const int lane = threadIdx.x;
  const size_t c = blockIdx.x;
  const uint32_t* in = words + c * W;
  uint8_t* o = out + c * out_len;
  const int cnt = min(max(counts[c], 0), out_len);
  tree_init(t, lane);

  // lane 0's bit reader: word wcur in hi, the next one in lo, r bits used
  auto word = [&](long long j) { return in[j < W ? j : W - 1]; };
  long long wcur = 0;
  uint32_t hi = 0, lo = 0;
  int r = 0;
  if (lane == 0) {
    hi = word(0);
    lo = word(1);
  }
  auto next_bit = [&]() {
    const int b = (hi >> (31 - r)) & 1;
    if (++r == 32) {
      r = 0;
      hi = lo;
      ++wcur;
      lo = word(wcur + 1);
    }
    return b;
  };

  for (int s0 = 0; s0 < cnt; s0 += kStage) {
    const int n = min(kStage, cnt - s0);
    for (int i = 0; i < n; ++i) {
      int sym = 0;
      if (lane == 0) {
        int k = 0;
        while (t.left[k] >= 0) k = next_bit() ? t.right[k] : t.left[k];
        if (k == t.nyt) {
          for (int j = 0; j < 8; ++j) sym = (sym << 1) | next_bit();
        } else {
          sym = t.symbol[k];
        }
        stage[i] = static_cast<uint8_t>(sym);
      }
      tree_update(t, sym, lane);
    }
    for (int i = lane; i < n; i += 32) o[s0 + i] = stage[i];
    __syncwarp();  // the stage is stored before the next block refills it
  }
  for (int i = cnt + lane; i < out_len; i += 32) o[i] = 0;
}

}  // namespace

extern "C" int fgk_encode_launch(const void* chunks, const void* lengths,
                                 void* words, void* bits, int C, int L,
                                 int n_words, void* stream) {
  fgk_encode_kernel<<<C, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks), static_cast<const int*>(lengths),
      static_cast<uint32_t*>(words), static_cast<int*>(bits), L, n_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fgk_decode_launch(const void* words, const void* counts,
                                 void* out, int C, int W, int out_len,
                                 void* stream) {
  fgk_decode_kernel<<<C, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(counts),
      static_cast<uint8_t*>(out), W, out_len);
  return static_cast<int>(cudaGetLastError());
}
