// Design variants of the one-thread FGK chain of csrc/fgk.cu, timed beside
// it by kernel_variants/time_fgk_variants.py; never built by the package.
// The same C entry points and contracts as csrc/fgk.cu. With no flag this
// file is the package's design as it was first built, before its
// read-ahead and its leaner bit I/O: a level's loads wait for the level
// before it to be decided, the next symbol's leaf is read when its turn
// comes, the decoder's walk tests for a leaf before it reads a child, its
// bit reader takes a bit at a time from two words, the encoder's
// accumulator masks its bits and counts in 64 bits, and the root's weight
// is read and raised. The flags change one part each:
//
//   -DBLOCKS      the successor from Knuth's block records (Dynamic Huffman
//                 coding, J. Algorithms 6, 1985) in place of the own test
//                 and the gallop: blk[s] names the block of slot s (a
//                 maximal run of one weight), lead[b] is block b's first
//                 slot, and a free stack hands out block ids. The successor
//                 is lead[blk[k]], two dependent loads; each increment keeps
//                 the records (the leader leaves its block, which passes to
//                 the next slot or is freed, and joins the block before it
//                 if that has its new weight). When k's sibling is the NYT
//                 and its successor its parent p = k - 1 (the one level
//                 where a weight passes its parent's), k and p rise together
//                 in one step, since p then leads its own weight. Modelled
//                 record for record by tests/test_torch_fgk_successor.py.
//   -DTWO_CLIMBS  the encoder climbs the code and the update apart, and the
//                 decoder climbs the update from the leaf (no notes of the
//                 walk): two dependent loads a level more than the package.
//   -DUNIFORM     every lane of the warp runs the chain, on the same values
//                 (equal stores to one address), in place of lane 0 alone:
//                 no branch of the chain is divergent, so the compiler needs
//                 no reconvergence around them. A timing probe only: the
//                 lanes' stores race in CUDA's memory model.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 514;
constexpr int kStage = 1024;
constexpr int kPath = 64;
constexpr int kLeaf = INT_MIN;
constexpr int kRight = 1 << 16;
constexpr unsigned kFull = 0xffffffffu;

struct Tree {
  int fq[kSlots + 1];
  int rec[kSlots];
  int ch[kSlots];
  int symslot[256];
#ifdef BLOCKS
  int blk[kSlots];
  int lead[kSlots];
  int free_ids[kSlots];
#endif
};

// lane 0's registers: the NYT slot and, with block records, the free stack's
// height
struct Chain {
  Tree& t;
  int* freq;
  int nyt = 0;
#ifdef BLOCKS
  int nfree = kSlots - 1;

  __device__ int pop() { return t.free_ids[--nfree]; }
  __device__ void push(int b) { t.free_ids[nfree++] = b; }
#endif
};

__device__ __forceinline__ int parent_of(int r) { return (r << 16) >> 16; }

__device__ __forceinline__ bool on_chain(int lane) {
#ifdef UNIFORM
  return true;
#else
  return lane == 0;
#endif
}

__device__ int* tree_init(Tree& t, int lane) {
  for (int i = lane; i < kSlots + 1; i += 32) t.fq[i] = i ? 0 : -1;
  for (int i = lane; i < kSlots; i += 32) {
    t.rec[i] = 0xffff;
    t.ch[i] = kLeaf;
#ifdef BLOCKS
    t.blk[i] = i ? -1 : 0;  // block 0: the lone root
    t.lead[i] = 0;
    t.free_ids[i] = kSlots - 1 - i;  // ids 513 .. 1, popped from the top
#endif
  }
  for (int i = lane; i < 256; i += 32) t.symslot[i] = -1;
  __syncwarp();
  return t.fq + 1;
}

__device__ __forceinline__ int gallop(const int* freq, int k, int w) {
  int d = 2;
  while (freq[max(k - d, -1)] == w) d <<= 1;
  int lo = max(k - d, -1), hi = k - (d >> 1);
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (freq[mid] == w) hi = mid; else lo = mid;
  }
  return hi;
}

// k's successor: the first slot of its run of weight
__device__ __forceinline__ int leader(Chain& s, int k, int w) {
#ifdef BLOCKS
  return s.t.lead[s.t.blk[k]];
#else
  return s.freq[k - 1] != w ? k : gallop(s.freq, k, w);
#endif
}

// s, the leader of its weight w, goes to w + 1
__device__ __forceinline__ void bump(Chain& c, int s, int w) {
#ifdef BLOCKS
  Tree& t = c.t;
  const int b = t.blk[s];
  if (s + 1 <= c.nyt && t.blk[s + 1] == b) t.lead[b] = s + 1;
  else c.push(b);
  if (s > 0 && c.freq[s - 1] == w + 1) {
    t.blk[s] = t.blk[s - 1];
  } else {
    const int nb = c.pop();
    t.lead[nb] = s;
    t.blk[s] = nb;
  }
#endif
  c.freq[s] = w + 1;
}

// k's sibling is the NYT and its successor its parent p = k - 1: k goes to
// w + 1 without a swap. Block records raise p too (p leads w in [0..p]);
// returns whether p's level is done.
__device__ __forceinline__ bool pair(Chain& c, int k, int p, int w) {
#ifdef BLOCKS
  Tree& t = c.t;
  const int b = t.blk[k];
  if (w == 0) t.lead[b] = c.nyt;  // the fresh leaf: the NYT stays in b
  else c.push(b);
  if (p > 0 && c.freq[p - 1] == w + 1) {
    t.blk[p] = t.blk[k] = t.blk[p - 1];
  } else {
    const int nb = c.pop();
    t.lead[nb] = p;
    t.blk[p] = t.blk[k] = nb;
  }
  c.freq[p] = w + 1;
  c.freq[k] = w + 1;
  return true;
#else
  c.freq[k] = w + 1;
  return false;
#endif
}

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

// The NYT split; the leaf's level is done. Returns (via done) whether o's
// level is done too.
__device__ __forceinline__ int split(Chain& c, int sym, bool& done) {
  Tree& t = c.t;
  const int o = c.nyt;
  t.ch[o] = (o + 2) | ((o + 1) << 16);
  t.rec[o + 1] = o | kRight;
  t.rec[o + 2] = o;
  t.ch[o + 1] = kLeaf | sym;
  t.ch[o + 2] = kLeaf;
  c.freq[o + 1] = 0;
  c.freq[o + 2] = 0;
  t.symslot[sym] = o + 1;
  c.nyt = o + 2;
#ifdef BLOCKS
  t.blk[o + 1] = t.blk[o + 2] = t.blk[o];
#endif
  done = pair(c, o + 1, o, 0);
  return o;
}

// The update from k to the root, the root's level included.
__device__ void climb(Chain& c, int k, bool done) {
  Tree& t = c.t;
  while (k != 0) {
    const int r = t.rec[k], p = parent_of(r);
    if (done) {
      done = false;
      k = p;
      continue;
    }
    const int w = c.freq[k];
    const int s = leader(c, k, w);
    if (s == p) {
      done = pair(c, k, p, w);
    } else {
      if (s != k) {
        swap_slots(t, k, s);
        k = s;
      }
      bump(c, k, w);
    }
    k = parent_of(t.rec[k]);
  }
  if (!done) bump(c, 0, c.freq[0]);
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
  Chain ch{t, tree_init(t, lane)};
  int* freq = ch.freq;

  uint64_t acc = 0;
  int nacc = 0;
  long long wi = 0, total = 0;
  auto put = [&](uint32_t v, int n) {
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
    if (on_chain(lane)) {
      int sym = stage[0];
      for (int i = 0; i < n; ++i) {
        const int next = stage[min(i + 1, n - 1)];
        const int k0 = t.symslot[sym];
        uint64_t code = 0;
        int d = 0;
#ifdef TWO_CLIMBS
        for (int q = k0 < 0 ? ch.nyt : k0; q != 0; ++d) {
          const int rq = t.rec[q];
          code |= static_cast<uint64_t>((rq >> 16) & 1) << min(d, 63);
          q = parent_of(rq);
        }
        bool done = false;
        const int k = k0 < 0 ? split(ch, sym, done) : k0;
        climb(ch, k, done);
#else
        bool done = false;
        int k = k0 < 0 ? split(ch, sym, done) : k0;
        bool rooted = true;  // the root's level is left to do here
        while (k != 0) {
          const int r = t.rec[k];
          code |= static_cast<uint64_t>((r >> 16) & 1) << min(d, 63);
          ++d;
          const int p = parent_of(r);
          if (done) {
            done = false;
            k = p;
            continue;
          }
          const int w = freq[k];
          const int s = leader(ch, k, w);
          if (s == k) {
            bump(ch, k, w);
            k = p;
            continue;
          }
          if (s == p) {
            done = pair(ch, k, p, w);
            k = p;
            continue;
          }
          for (int q = p; q != 0; ++d) {
            const int rq = t.rec[q];
            code |= static_cast<uint64_t>((rq >> 16) & 1) << min(d, 63);
            q = parent_of(rq);
          }
          climb(ch, k, false);
          rooted = false;
          break;
        }
        if (rooted && !done) bump(ch, 0, freq[0]);
#endif
        if (d > 32) {
          put(static_cast<uint32_t>(code >> 32), d - 32);
          put(static_cast<uint32_t>(code), 32);
        } else {
          put(static_cast<uint32_t>(code), d);
        }
        total += d;
        if (k0 < 0) {
          put(static_cast<uint32_t>(sym), 8);
          total += 8;
        }
        sym = next;
      }
    }
    __syncwarp();
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
  __shared__ int path_slot[kPath], path_w[kPath];
  const int lane = threadIdx.x;
  const size_t c = blockIdx.x;
  const uint32_t* in = words + c * W;
  uint8_t* o = out + c * out_len;
  const int cnt = min(max(counts[c], 0), out_len);
  Chain ch{t, tree_init(t, lane)};
  int* freq = ch.freq;

  auto word = [&](long long j) { return in[j < W ? j : W - 1]; };
  long long wcur = 0;
  uint32_t hi = 0, lo = 0;
  int r = 0;
  if (on_chain(lane)) {
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
    if (on_chain(lane)) {
      for (int i = 0; i < n; ++i) {
        int k = 0, depth = 0, bad = -1, cw = t.ch[0];
        while (cw >= 0) {
          k = next_bit() ? (cw >> 16) : (cw & 0xffff);
          cw = t.ch[k];
#ifndef TWO_CLIMBS
          const int w = freq[k];
#ifdef BLOCKS
          if (t.lead[t.blk[k]] != k) bad = depth;
#else
          if (freq[k - 1] == w) bad = depth;
#endif
          path_slot[depth] = k;
          path_w[depth] = w;
          ++depth;
#endif
        }
        int sym = cw & 0xff;
        bool done = false;
        const bool fresh = k == ch.nyt;
        if (fresh) {
          sym = 0;
          for (int j = 0; j < 8; ++j) sym = (sym << 1) | next_bit();
          split(ch, sym, done);
        }
        stage[i] = static_cast<uint8_t>(sym);
#ifdef TWO_CLIMBS
        climb(ch, k, done);
#else
        for (int j = depth - 1; j > bad; --j) {
          if (done) {
            done = false;
            continue;
          }
          bump(ch, path_slot[j], path_w[j]);
        }
        if (bad >= 0) climb(ch, path_slot[bad], false);
        else if (!done) bump(ch, 0, freq[0]);
#endif
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) o[s0 + i] = stage[i];
    __syncwarp();
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
