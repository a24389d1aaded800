// Variant of huffman_codec_tpu_torch/csrc/repad.cu for timing
// (kernel_variants/time_decode_variants.py): its first one-pass design,
// in which warp 0 alone looks back over the status words, 32 blocks a
// round, and each thread stores a line before it loads the next.

// Re-pad dense wire words into the decoder's fixed-stride lane layout.
//
// Replaces: huffman_codec_tpu/ops/pallas_kernels.py, repad_words
// (pallas_call at line 1125, body _repad_kernel). It takes the flat dense
// words of the models/chunked.py _repad_words contract, not the TPU
// kernel's 128-word-aligned staging.
//
// Contract: flat (N,) u32 holds the step's lanes back to back (chunk after
// chunk, lane after lane), lane_words (C, nl) i32 their word counts ->
// out (C, nl * wb) u32 with lane k of chunk c at columns
// [k*wb, k*wb + lane_words[c, k]). Every other slot is 0 (the contract
// allows anything there).
//
// Bound on the H100: bytes. It reads the payload once and writes the
// padded layout once; a lane's start in the dense words is an exclusive
// scan of the C * nl lane word counts.
//
// Design: one pass over the output, as a grid of blocks of 4096 slots of
// the flattened (C * nl, wb) layout, so the copy covers the card whatever
// the geometry (one chunk of 112 fat lanes, or 256 chunks of 172 narrow
// ones). A block takes its span from an atomic counter in launch order and
// owns the lanes whose first slot lies in it. It loads the word counts of
// the lanes its span touches, scans them once (a block scan), publishes
// the sum of its own lanes in a status word and finds the words of every
// earlier block's lanes by a decoupled look-back over those status words
// (warp 0, 32 blocks a round). That gives each lane it touches its start
// with no per-block re-reduction of the manifest and no serial scan. The
// copy then stores 16-byte lines (4 slots a thread, where wb % 4 == 0,
// else 4 single words), loading each line's words from the lane's run in
// the dense words with coalesced 4-byte loads; slots past a lane's words
// are written as zeros without a load. A slot's lane comes from a
// multiply-high by a reciprocal of wb, not a division. (The TPU kernel's
// butterfly routing stands in for a scatter it does not have.)

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // slots a thread stores at once
constexpr int kIters = 4;
constexpr int kSpan = kThreads * kVec * kIters;  // slots a block
// lanes a span touches: every slot its own lane (wb = 1), and one more
constexpr int kMaxLanes = kSpan + 1;
constexpr int kPerThread = (kMaxLanes + kThreads - 1) / kThreads;

// status word of a block: flag << 62 | a count of words (< 2^31)
constexpr uint64_t kAgg = 1;   // the words of its own lanes
constexpr uint64_t kIncl = 2;  // the words of all lanes up to its last own

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

// Warp 0: the words of the lanes owned by blocks 0 .. b - 1, from their
// status words: lane k reads block hi - k, 32 blocks a round, back to the
// first one that has published its inclusive count.
__device__ long long look_back(const uint64_t* status, int b) {
  const int lane = threadIdx.x & 31;
  long long acc = 0;
  for (int hi = b - 1; hi >= 0; hi -= 32) {
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
      // the blocks waited on are running and publish within microseconds;
      // a wait of seconds is a fault, which ends the launch with an error
      if (spin == 1u << 26) __trap();
      __nanosleep(32);
    }
    long long v = ((need >> lane & 1) && idx >= 0)
                      ? static_cast<long long>(w & ((1ull << 62) - 1))
                      : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(~0u, v, d);
    acc += v;
    if (stop) break;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
repad_kernel(const uint32_t* __restrict__ flat,
             const int* __restrict__ lane_words, uint32_t* __restrict__ out,
             uint64_t* scratch, int wb, int total, int n_flat, int n_blocks) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_lw[kMaxLanes];
  __shared__ int s_start[kMaxLanes + 1];  // exclusive, from the span's first
  __shared__ int s_b;
  __shared__ long long s_before;

  if (threadIdx.x == 0) {
    // the block counter follows the status words
    s_b = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(scratch + n_blocks), 1u));
  }
  __syncthreads();
  const int b = s_b;
  const int s0 = b * kSpan;
  const int s1 = min(s0 + kSpan, total);
  // slot -> lane by a multiply-high with ceil(2^64 / wb): exact for slots
  // below 2^32 and wb below 2^31
  const unsigned long long recip = wb > 1 ? ~0ull / wb + 1 : 0;
  auto lane_of = [&](long long slot) {
    return static_cast<int>(
        wb > 1 ? __umul64hi(static_cast<unsigned long long>(slot), recip)
               : slot);
  };
  const int lane_lo = lane_of(s0);               // the first lane touched
  const int nt = lane_of(s1 - 1) + 1 - lane_lo;  // lanes touched
  // the lanes whose first slot lies in [s0, s1), local to lane_lo
  const int own_lo = lane_of(static_cast<long long>(s0) + wb - 1) - lane_lo;
  const int own_hi = lane_of(static_cast<long long>(s1) + wb - 1) - lane_lo;

  // the touched lanes' word counts and their exclusive scan
  int run[kPerThread];
  int sum = 0;
  const int i0 = threadIdx.x * kPerThread;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = i0 + k;
    run[k] = i < nt ? max(lane_words[lane_lo + i], 0) : 0;
    if (i < nt) s_lw[i] = run[k];
    sum += run[k];
  }
  int excl;
  Scan(scan_tmp).ExclusiveSum(sum, excl);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = i0 + k;
    if (i <= nt) s_start[i] = excl;
    excl += run[k];
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const long long agg = s_start[own_hi] - s_start[own_lo];
    long long before = 0;
    if (b == 0) {
      if (threadIdx.x == 0) st_relaxed(scratch, kIncl << 62 | agg);
    } else {
      if (threadIdx.x == 0) st_relaxed(scratch + b, kAgg << 62 | agg);
      before = look_back(scratch, b);
      if (threadIdx.x == 0) {
        st_relaxed(scratch + b, kIncl << 62 | (before + agg));
      }
    }
    if (threadIdx.x == 0) s_before = before;
  }
  __syncthreads();
  // dense word of the span's first lane's first word
  const long long base = s_before - s_start[own_lo];

  if ((wb & 3) == 0) {
    // every 4-slot line lies in one lane
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int slot = s0 + (it * kThreads + threadIdx.x) * kVec;
      if (slot >= s1) break;
      const int i = lane_of(slot) - lane_lo;
      const int j = slot - (lane_lo + i) * wb;
      const int lw = s_lw[i];
      uint32_t v[kVec] = {0u, 0u, 0u, 0u};
      if (j < lw) {
        const long long src = base + s_start[i] + j;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (j + e < lw && src + e < n_flat) v[e] = flat[src + e];
        }
      }
      *reinterpret_cast<uint4*>(out + slot) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      int slot = s0 + (it * kThreads + threadIdx.x) * kVec;
      if (slot >= s1) break;
      int i = lane_of(slot) - lane_lo;
      int j = slot - (lane_lo + i) * wb;
      for (int e = 0; e < kVec && slot < s1; ++e, ++slot, ++j) {
        if (j == wb) {
          j = 0;
          ++i;
        }
        const long long src = base + s_start[i] + j;
        out[slot] = (j < s_lw[i] && src < n_flat) ? flat[src] : 0u;
      }
    }
  }
}

}  // namespace

extern "C" int repad_launch(const void* flat, const void* lane_words,
                            void* out, void* scratch, int scratch_words,
                            int C, int nl, int wb, int n_flat, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(C) * nl * wb;
  if (total == 0) return 0;
  if (wb < 1 || total >= (1ll << 31) - kSpan)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = static_cast<int>((total + kSpan - 1) / kSpan);
  // the caller sizes the scratch from its own copy of kSpan: refuse a
  // buffer too short for this build's spans rather than write past it
  if (scratch_words < n_blocks + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // a status word a block, then the block counter
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, (static_cast<size_t>(n_blocks) + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  repad_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(flat), static_cast<const int*>(lane_words),
      static_cast<uint32_t*>(out), static_cast<uint64_t*>(scratch), wb,
      static_cast<int>(total), n_flat, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
