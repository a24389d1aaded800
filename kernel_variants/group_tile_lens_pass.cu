// Design variant of csrc/group_tile_lens.cu: the warp design as first
// built, where a tile whose next byte is entered in a state the reset
// would not leave (after a tile's third equal literal, or after one or two
// literals equal to it) ends the pass, and a new pass, its bytes reloaded
// and its four chains and map scan run again, starts at that byte. The
// package's kernel instead reruns the one lane holding that byte and scans
// the maps again inside the pass. Timed by time_walk_variants.py beside
// it; same contract and the same two instances.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 16;          // bytes a lane holds in a pass
constexpr int kWords = kItems / 4;
constexpr int kPass = 32 * kItems;  // bytes a pass covers
constexpr int kWarps = 4;           // groups a block
constexpr int kWin = 4096;          // bytes of a warp's window
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPass + 15 <= kWin, "a pass must fit a window");

__device__ __forceinline__ int byte_of(const uint32_t (&xw)[kWords], int j) {
  return (xw[j >> 2] >> (8 * (j & 3))) & 255;
}

// one byte of the reference decoder FSM; bit j of cnt marks a count byte
__device__ __forceinline__ void fsm_step(int& count, int& match,
                                         unsigned& cnt, int c, int j) {
  const bool is_cnt = count == 3;
  if (is_cnt) cnt |= 1u << j;
  count = is_cnt ? 0 : (match == c ? count + 1 : 1);
  match = is_cnt ? match : c;
}

// the abstract state in which a byte b0 (followed by b1) is entered
__device__ __forceinline__ unsigned abstract_state(int count, int match,
                                                   int b0, int b1) {
  return count < 3 ? count * 2 + (match == b0) : 6 + (match == b1);
}

// maps of 8 abstract states in two forms: bytes (lo: states 0-3, hi:
// states 4-7), the table of a byte permute, and nibbles, its selector
__device__ __forceinline__ uint32_t nibbles(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo | lo >> 4, hi | hi >> 4, 0x6420);
}

template <bool kDecoded>
__global__ void __launch_bounds__(32 * kWarps)
group_tile_lens_kernel(const uint8_t* __restrict__ stream,
                       const int* __restrict__ group_offs,
                       const int* __restrict__ sizes, int* __restrict__ lens,
                       int* __restrict__ decoded, int ng, int K, int n,
                       int total, int group_cap) {
  __shared__ __align__(16) uint8_t s_win[kWarps][kWin + 16];
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= ng) return;  // whole warps
  uint8_t* win = s_win[threadIdx.x >> 5];
  const long long off = group_offs[g];
  const long long end = g + 1 < ng ? group_offs[g + 1] : total;
  const int glen = static_cast<int>(
      max(0LL, min(end - off, static_cast<long long>(group_cap))));
  const size_t gk = static_cast<size_t>(g) * K;

  // tiles [tb, tb + 32): lane k holds tile tb + k's size, length and
  // decoded size; the next batch's sizes are loaded ahead
  int tb = 0;
  int sz_cur = lane < K ? sizes[gk + lane] : 0;
  int sz_next = 32 + lane < K ? sizes[gk + 32 + lane] : 0;
  int len_r = 0, dec_r = 0;

  int t = 0;              // the tile being walked
  int q = 0;              // the pass's first byte, group-relative
  int count = 0, match = -1;  // FSM state at q
  int before = 0;         // tile t's bytes before q
  int produced = 0;       // tile t's output before q
  int wlo = 0;            // the window holds group bytes [wlo, wlo + kWin)
  bool loaded = false;

  while (q < glen && t < K) {
    if (!loaded || q + kPass > wlo + kWin) {
      const long long a0 = (off + q) & ~15LL;
      wlo = static_cast<int>(a0 - off);
      const int lines = static_cast<int>(
          min(static_cast<long long>(kWin / 16), (off + glen - a0 + 15) / 16));
      __syncwarp();
      for (int l = lane; l < lines; l += 32) {
        const long long a = a0 + 16LL * l;
        uint4 v;
        if (a >= 0 && a + 16 <= n) {
          v = *reinterpret_cast<const uint4*>(stream + a);
        } else {
          uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const long long at = min(max(a + b, 0LL), n - 1LL);
            w[b >> 2] |= static_cast<uint32_t>(stream[at]) << (8 * (b & 3));
          }
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
        *reinterpret_cast<uint4*>(win + 16 * l) = v;
      }
      __syncwarp();
      loaded = true;
    }

    // the lane's bytes [q + lane * kItems, + kItems), and the next lane's
    // first two
    const int idx = q - wlo + lane * kItems;
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(win) + (idx >> 2);
    const int sh = 8 * (idx & 3);
    uint32_t xw[kWords];
    {
      uint32_t w[kWords + 1];
#pragma unroll
      for (int k = 0; k <= kWords; ++k) w[k] = w32[k];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        xw[k] = __funnelshift_r(w[k], w[k + 1], sh);
      }
    }
    const int nvalid = min(max(glen - q - lane * kItems, 0), kItems);
    const uint32_t nxt = __shfl_down_sync(kFull, xw[0], 1);
    const int n0 = nxt & 255, n1 = (nxt >> 8) & 255;
    const int x0 = byte_of(xw, 0), x1 = byte_of(xw, 1);

    // 1. the four chains: entry states {0, 1, 2, 4} leave (1, x0), 3
    //    leaves (2, x0), 5 leaves (3, x0); 6 and 7 make x0 a count byte and
    //    x1 leaves (1, x1)
    int ca = 1, ma = x0, cb = 2, mb = x0, cc = 3, mc = x0, cd = 1, md = x1;
    unsigned ka = 0, kb = 0, kc = 0, kd = 1;
#pragma unroll
    for (int j = 1; j < kItems; ++j) {
      const int c = byte_of(xw, j);
      fsm_step(ca, ma, ka, c, j);
      fsm_step(cb, mb, kb, c, j);
      fsm_step(cc, mc, kc, c, j);
      if (j >= 2) fsm_step(cd, md, kd, c, j);
    }
    const uint32_t ea = abstract_state(ca, ma, n0, n1);
    const uint32_t eb = abstract_state(cb, mb, n0, n1);
    const uint32_t ec = abstract_state(cc, mc, n0, n1);
    const uint32_t ed = abstract_state(cd, md, n0, n1);
    uint32_t lo = ea | ea << 8 | ea << 16 | eb << 24;
    uint32_t hi = ea | ec << 8 | ed << 16 | ed << 24;

    // 2. compose the maps across the warp (inclusive), then each lane's
    //    entry state from the pass's
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t a = __shfl_up_sync(kFull, nibbles(lo, hi), d);
      if (lane >= d) {
        const uint32_t rlo = __byte_perm(lo, hi, a & 0xffff);
        hi = __byte_perm(lo, hi, a >> 16);
        lo = rlo;
      }
    }
    const uint32_t first = __shfl_sync(kFull, xw[0], 0);
    const unsigned s0 = abstract_state(count, match, first & 255,
                                       (first >> 8) & 255);
    const uint32_t excl = __shfl_up_sync(kFull, nibbles(lo, hi), 1);
    const unsigned E = lane == 0 ? s0 : (excl >> (4 * s0)) & 7;
    const unsigned cnt = E == 3 ? kb : E == 5 ? kc : E >= 6 ? kd : ka;
    const int fc = E == 3 ? cb : E == 5 ? cc : E >= 6 ? cd : ca;
    const int fm = E == 3 ? mb : E == 5 ? mc : E >= 6 ? md : ma;

    // running output of each byte within the lane; the bytes whose entry
    // state a literal leaves as the reset does
    int cum[kItems];
    unsigned compat = (0x17u >> E) & 1u;
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int c = byte_of(xw, j);
      const bool is_cnt = (cnt >> j) & 1u;
      sum += j < nvalid ? (is_cnt ? c : 1) : 0;
      cum[j] = sum;
      if (j > 0 && !is_cnt &&
          (((cnt >> (j - 1)) & 1u) || byte_of(xw, j - 1) != c)) {
        compat |= 1u << j;
      }
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int lane_base = incl - sum;
    const int pass_out = __shfl_sync(kFull, incl, 31);

    // 3. cut the tiles that end inside the pass
    int start = 0;          // the current tile's first byte in the pass
    int base = -produced;   // tile output = running output - base
    bool reset = false;
    while (t < K) {
      const int target = base + __shfl_sync(kFull, sz_cur, t - tb);
      const int lo_j = start - lane * kItems;
      int hit = kItems, hit_out = 0;
#pragma unroll
      for (int j = kItems - 1; j >= 0; --j) {
        if (j >= lo_j && j < nvalid && lane_base + cum[j] >= target) {
          hit = j;
          hit_out = lane_base + cum[j];
        }
      }
      const unsigned m = __ballot_sync(kFull, hit < kItems);
      if (!m) break;
      const int f = __ffs(m) - 1;
      const int e = f * kItems + __shfl_sync(kFull, hit, f);
      const int e_out = __shfl_sync(kFull, hit_out, f);
      if (lane == t - tb) {
        len_r = before + e - start + 1;
        dec_r = e_out - base;
      }
      before = 0;
      start = e + 1;
      base = e_out;
      if (++t - tb == 32) {
        if (tb + lane < K) {
          lens[gk + tb + lane] = len_r;
          if (kDecoded) decoded[gk + tb + lane] = dec_r;
        }
        tb += 32;
        sz_cur = sz_next;
        sz_next = tb + 32 + lane < K ? sizes[gk + tb + 32 + lane] : 0;
        len_r = dec_r = 0;
      }
      if (start == kPass || !((__shfl_sync(kFull, compat, start / kItems) >>
                               (start % kItems)) & 1u)) {
        reset = true;
        break;
      }
    }
    if (reset) {  // the next tile from the reset state at its first byte
      q += start;
      count = 0;
      match = -1;
      produced = 0;
    } else {      // tile t goes on past the pass
      before += min(glen - q, kPass) - start;
      produced = pass_out - base;
      count = __shfl_sync(kFull, fc, 31);
      match = __shfl_sync(kFull, fm, 31);
      q += kPass;
    }
  }
  if (t < K && lane == t - tb) {  // the tile the group's bytes end inside
    len_r = before;
    dec_r = produced;
  }
  if (tb + lane < K) {
    lens[gk + tb + lane] = len_r;
    if (kDecoded) decoded[gk + tb + lane] = dec_r;
  }
  for (int k = tb + 32 + lane; k < K; k += 32) {  // tiles never reached
    lens[gk + k] = 0;
    if (kDecoded) decoded[gk + k] = 0;
  }
}

}  // namespace

extern "C" int group_tile_lens_launch(const void* stream,
                                      const void* group_offs,
                                      const void* sizes, void* lens,
                                      void* decoded, int ng, int K, int n,
                                      int total, int group_cap,
                                      void* cuda_stream) {
  const int blocks = (ng + kWarps - 1) / kWarps;
  auto kernel = decoded ? group_tile_lens_kernel<true>
                        : group_tile_lens_kernel<false>;
  kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream),
      static_cast<const int*>(group_offs), static_cast<const int*>(sizes),
      static_cast<int*>(lens), static_cast<int*>(decoded), ng, K, n, total,
      group_cap);
  return static_cast<int>(cudaGetLastError());
}
