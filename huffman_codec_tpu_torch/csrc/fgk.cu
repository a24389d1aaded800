// FGK adaptive Huffman encode and decode of independent chunk streams.
//
// Replaces no TPU kernel: the JAX package runs each chunk's serial tree
// update as one XLA scan over symbol positions, vmapped over the chunks
// (huffman_codec_tpu/ops/fgk.py, fgk_encode_batch and fgk_decode_batch).
// As PyTorch ops a symbol costs a few dozen small launches a tree level.
//
// Tree: the slot form of the JAX package. Slot k holds node number 512 - k,
// the root is slot 0, new nodes append; a swap exchanges the contents of two
// slots (children or symbol, and weight) while the positions keep their
// parents. After a symbol, from its leaf up to the root, a node is swapped
// with its successor, the lowest slot in [0..k] of its weight, unless that
// slot is k or k's parent, and its weight goes up by one; the root's goes up
// last. A first occurrence first splits the NYT node into a new NYT (left)
// and the symbol's leaf (right), and is coded as the NYT node's code
// followed by the symbol's 8 bits.
//
// fgk_encode: chunks (C, L) u8, lengths (C,) i32 -> words (C, n_words) u32,
// the codes MSB-first (bit p is bit 31 - p % 32 of word p / 32), zero past
// the stream, words past n_words dropped; bits (C,) i32, the stream's bits.
// Codes may pass 32 bits (up to 64). fgk_decode: words (C, W) u32, counts
// (C,) i32 -> out (C, out_len) u8, the first counts[c] symbols, zero past
// them; a read past a row reads its last word.
//
// Bound on the H100: the serial chain of the longest chunk. Each symbol is
// one climb of the tree (encode: the code; decode: the root-to-leaf walk)
// and one climb of the update, every level a dependent shared-memory access
// at least; the bytes moved are far below that.
//
// Design: one thread a chain. A block is one warp and one chunk; lane 0
// runs the chain alone, with no barrier, shuffle or warp reduction in a
// tree level, and the other lanes only stage the symbols in and out
// through shared memory, 1024 at a time. All chunks of a launch are
// resident at once, so a launch takes its longest chain: what counts is
// the clocks of a level. The card holds many launches' blocks at once
// (fgk_resident_blocks), so the codec runs the launches of one request's
// steps side by side on streams of their own, and a request takes about
// its longest chain. The tree (7.2 KB of shared memory) is three records
// a slot:
//   rec[s]  the position: parent slot (low 16 bits, -1 at the root) and
//           side (bit 16: a right child), which a swap leaves in place;
//   ch[s]   the content: left | right << 16, or kLeaf | symbol at a leaf;
//   freq[s] the weight, int32 (a v1 chain is a whole file), with a
//           sentinel -1 at slot -1.
// The successor without a scan: the prefix [0..k] is sorted by weight,
// non-increasing (the nodes raised earlier in a climb sit below k), so k's
// weight w is one run ending at k. k leads it when freq[k-1] != w, which
// holds at nearly every level; else a gallop back from k (k-2, k-4, ...)
// and a binary search find the run's first slot. A swap moves two content
// words and points the moved children (or the moved leaf's symbol) back.
// (Knuth's block records, kept in O(1) a level, give the same slot and
// were timed beside this, `git show 128a866:kernel_variants/fgk_chain.cu`:
// two dependent loads for the leader and the records' upkeep cost more
// than the own test and the rare gallop.)
// The encoder takes the code and the update in one climb while no level
// swaps: a weight increment changes no edge, so the code read on the way
// up is the tree's before the update. At the first swap it reads the rest
// of the code on, then finishes the update (climb). Each level reads the
// next level's records before it is decided, and the next symbol's leaf
// is read during the current one and kept unless the update split or
// swapped. The decoder's walk reads a content word a level, and its
// child's records before it knows the content is no leaf (a leaf's masked
// halves are slots in range); it notes each level's slot, next weight and
// own test, the levels below the deepest failed test take their increments
// from the notes, and only from there does the update climb. The root's
// weight is the count of symbols so far, written, not read. The bit I/O
// stays in registers: the encoder appends each code to a 64-bit
// accumulator and stores a word when 32 bits are full; the decoder reads a
// 64-bit window, refilled a word at a time from one loaded a refill ahead.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 514;       // 513 live slots and a spare one
constexpr int kStage = 1024;      // symbols staged in shared memory at a time
constexpr int kPath = 64;         // < 2^31 symbols make a tree < 46 deep
constexpr int kLeaf = INT_MIN;    // a leaf's content: kLeaf | symbol
constexpr int kRight = 1 << 16;   // a position's side bit
constexpr unsigned kFull = 0xffffffffu;

struct Tree {
  int fq[kSlots + 1];  // fq[0] the sentinel, slot s's weight at fq[s + 1]
  int rec[kSlots];
  int ch[kSlots];
  int symslot[256];
};

__device__ __forceinline__ int parent_of(int r) { return (r << 16) >> 16; }

// Every lane: a tree of one NYT node, the root. Returns the weights,
// freq[-1] the sentinel.
__device__ int* tree_init(Tree& t, int lane) {
  for (int i = lane; i < kSlots + 1; i += 32) t.fq[i] = i ? 0 : -1;
  for (int i = lane; i < kSlots; i += 32) {
    t.rec[i] = 0xffff;  // parent -1
    t.ch[i] = kLeaf;
  }
  for (int i = lane; i < 256; i += 32) t.symslot[i] = -1;
  __syncwarp();
  return t.fq + 1;
}

// The first slot of the run of weight w that ends at k, given freq[k-1] ==
// w: gallop back, then a binary search between the last two probes.
__device__ __forceinline__ int leader(const int* freq, int k, int w) {
  int d = 2;
  while (freq[max(k - d, -1)] == w) d <<= 1;
  int lo = max(k - d, -1), hi = k - (d >> 1);
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (freq[mid] == w) hi = mid; else lo = mid;
  }
  return hi;
}

// Slot s now holds content c: its children, or its leaf's symbol, point
// back at s (a left child's side is 0, a right child's 1).
__device__ __forceinline__ void repoint(Tree& t, int s, int c) {
  if (c >= 0) {
    t.rec[c & 0xffff] = s;
    t.rec[c >> 16] = s | kRight;
  } else {
    t.symslot[c & 0xff] = s;
  }
}

__device__ __forceinline__ void swap_slots(Tree& t, int a, int b) {
  const int ca = t.ch[a], cb = t.ch[b];
  t.ch[a] = cb;
  t.ch[b] = ca;
  repoint(t, a, cb);
  repoint(t, b, ca);
}

// A first occurrence of sym: the NYT slot o gets a new NYT (left, o + 2)
// and sym's leaf (right, o + 1). The leaf's own level is done here: its
// successor is o, its parent, so it takes weight 1 without a swap.
// Returns o, where the climb goes on.
__device__ __forceinline__ int split(Tree& t, int* freq, int& nyt,
                                     int sym) {
  const int o = nyt;
  t.ch[o] = (o + 2) | ((o + 1) << 16);
  t.rec[o + 1] = o | kRight;
  t.rec[o + 2] = o;
  t.ch[o + 1] = kLeaf | sym;
  t.ch[o + 2] = kLeaf;
  freq[o + 1] = 1;
  freq[o + 2] = 0;
  t.symslot[sym] = o + 1;
  nyt = o + 2;
  return o;
}

// The update from slot k up to the root, the root's weight excluded.
__device__ void climb(Tree& t, int* freq, int k) {
  while (k != 0) {
    const int w = freq[k];
    if (freq[k - 1] == w) {
      const int s = leader(freq, k, w);
      if (s != parent_of(t.rec[k])) {  // k's content moves to s
        swap_slots(t, k, s);
        k = s;
      }
    }
    freq[k] = w + 1;
    k = parent_of(t.rec[k]);
  }
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
  int* freq = tree_init(t, lane);

  int nyt = 0;       // lane 0's registers from here
  uint64_t acc = 0;  // nacc < 32 pending bits at the bottom (higher: stale)
  int nacc = 0, wi = 0, total = 0;
  auto put = [&](uint32_t v, int n) {  // n in [0, 32], v < 2^n
    acc = (acc << n) | v;
    nacc += n;
    if (nacc >= 32) {
      nacc -= 32;
      if (wi < n_words) out[wi] = static_cast<uint32_t>(acc >> nacc);
      ++wi;
    }
  };

  for (int s0 = 0; s0 < len; s0 += kStage) {
    const int n = min(kStage, len - s0);
    for (int i = lane; i < n; i += 32) stage[i] = in[s0 + i];
    __syncwarp();
    if (lane == 0) {
      int sym = stage[0];
      int k0 = t.symslot[sym];
      for (int i = 0; i < n; ++i) {
        const int next = stage[min(i + 1, n - 1)];
        // the next symbol's leaf, read ahead: kept unless this update
        // splits or swaps
        const int k0_next = t.symslot[next];
        bool moved = k0 < 0;
        int k = moved ? split(t, freq, nyt, sym) : k0;
        uint64_t code = 0;  // bit d: the edge d levels above the start
        int d = 0;
        if (k != 0) {  // the code and the update in one climb
          int r = t.rec[k], w = freq[k], wm = freq[k - 1];
          for (;;) {
            const int p = parent_of(r);
            // the next level's records, read before this one is decided
            const int rp = t.rec[p], wp = freq[p], wpm = freq[p - 1];
            code |= static_cast<uint64_t>((r >> 16) & 1) << min(d, 63);
            ++d;
            if (wm == w && leader(freq, k, w) != p) {
              // a swap: the rest of the code, then the update from k
              for (int q = p; q != 0; ++d) {
                const int rq = t.rec[q];
                code |= static_cast<uint64_t>((rq >> 16) & 1) << min(d, 63);
                q = parent_of(rq);
              }
              climb(t, freq, k);
              moved = true;
              break;
            }
            freq[k] = w + 1;
            if (p == 0) break;
            k = p;
            r = rp;
            w = wp;
            wm = wpm;
          }
        }
        freq[0] = s0 + i + 1;  // the root's weight: the symbols so far
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
        k0 = moved ? t.symslot[next] : k0_next;
        sym = next;
      }
    }
    __syncwarp();  // the stage is read before the next block refills it
  }
  if (lane == 0) {
    if (nacc > 0) {
      if (wi < n_words) out[wi] = static_cast<uint32_t>(acc << (32 - nacc));
      ++wi;
    }
    bits[c] = total;
  }
  const int end = __shfl_sync(kFull, wi, 0);
  for (int j = end + lane; j < n_words; j += 32) out[j] = 0;
}

__global__ void __launch_bounds__(32)
fgk_decode_kernel(const uint32_t* __restrict__ words,
                  const int* __restrict__ counts, uint8_t* __restrict__ out,
                  int W, int out_len) {
  __shared__ Tree t;
  __shared__ uint8_t stage[kStage];
  __shared__ int2 notes[kPath];  // the walk's slots and their next weights
  const int lane = threadIdx.x;
  const size_t c = blockIdx.x;
  const uint32_t* in = words + c * W;
  uint8_t* o = out + c * out_len;
  const int cnt = min(max(counts[c], 0), out_len);
  int* freq = tree_init(t, lane);

  // lane 0's bit reader: avail bits at the top of win; the next word,
  // loaded a refill ahead, in nxt; word wn after it
  uint64_t win = 0;
  uint32_t nxt = 0;
  int avail = 0, wn = 1, nyt = 0;
  if (lane == 0) nxt = in[0];
  auto refill = [&]() {  // avail <= 32
    win |= static_cast<uint64_t>(nxt) << (32 - avail);
    avail += 32;
    nxt = in[min(wn, W - 1)];
    ++wn;
  };

  for (int s0 = 0; s0 < cnt; s0 += kStage) {
    const int n = min(kStage, cnt - s0);
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        if (avail <= 32) refill();
        // the walk: a level reads its child's records before it knows
        // that its own content is no leaf (a leaf's masked halves are
        // slots in range), and notes each level's slot, next weight and
        // own test
        int k = 0, depth = 0, bad = -1, cw = t.ch[0];
        for (;;) {
          const int kn = (win >> 63) ? (cw >> 16) & 0x3ff : cw & 0x3ff;
          const int cn = t.ch[kn], w = freq[kn], wm = freq[kn - 1];
          if (cw < 0) break;
          win <<= 1;
          if (--avail == 0) refill();
          k = kn;
          cw = cn;
          bad = wm == w ? depth : bad;
          notes[depth] = make_int2(k, w + 1);
          ++depth;
        }
        int sym = cw & 0xff;
        if (k == nyt) {
          if (avail < 8) refill();
          sym = static_cast<int>(win >> 56);
          win <<= 8;
          avail -= 8;
          split(t, freq, nyt, sym);
        }
        stage[i] = static_cast<uint8_t>(sym);
        int j = depth - 1;  // the levels below the deepest failed test
        for (; j - 1 > bad; j -= 2) {
          const int2 a = notes[j], b = notes[j - 1];
          freq[a.x] = a.y;
          freq[b.x] = b.y;
        }
        if (j > bad) freq[notes[j].x] = notes[j].y;
        if (bad >= 0) climb(t, freq, notes[bad].x);
        freq[0] = s0 + i + 1;
      }
    }
    __syncwarp();
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

// The blocks of the FGK kernels the current device holds at once: the
// blocks an SM holds of the kernel with the larger footprint (the
// decoder's, whose notes add to the tree and the stage), times the SMs.
extern "C" int fgk_resident_blocks(int* blocks) {
  int dev = 0, sms = 0, enc = 0, dec = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &enc, fgk_encode_kernel, 32, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &dec, fgk_decode_kernel, 32, 0);
  *blocks = (enc < dec ? enc : dec) * sms;
  return static_cast<int>(err);
}
