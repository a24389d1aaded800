// Variant of huffman_codec_tpu_torch/csrc/repad.cu for timing
// (kernel_variants/time_decode_variants.py): two launches instead of one
// pass. The first scans the C * nl lane word counts into the lanes' starts
// (a block of 1024 threads a tile of 4096 lanes, a decoupled look-back over
// the tiles by warp 0), kept in the scratch after the tiles' status words;
// the second copies, 4096 output slots a block, each 16-byte line's lane
// from a multiply-high and its start from the first launch's array. The
// scratch holds a status word a tile, the tile counter and (C * nl + 1)
// ints of starts.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kIters = 4;
constexpr int kSpan = kThreads * kVec * kIters;
constexpr uint64_t kAgg = 1;
constexpr uint64_t kIncl = 2;

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
      need = stop ? stop ^ (stop - 1) : ~0u;
      if ((ready & need) == need) break;
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

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ lane_words, uint64_t* scratch,
            int* starts, int n_lanes, int n_tiles) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int s_t;
  __shared__ long long s_before;
  if (threadIdx.x == 0) {
    s_t = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(scratch + n_tiles), 1u));
  }
  __syncthreads();
  const int t = s_t;
  const int i0 = t * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = i0 + k < n_lanes ? max(lane_words[i0 + k], 0) : 0;
    sum += v[k];
  }
  int excl, agg;
  Scan(tmp).ExclusiveSum(sum, excl, agg);
  if (threadIdx.x < 32) {
    long long before = 0;
    if (t == 0) {
      if (threadIdx.x == 0) st_relaxed(scratch, kIncl << 62 | agg);
    } else {
      if (threadIdx.x == 0) st_relaxed(scratch + t, kAgg << 62 | agg);
      before = look_back(scratch, t);
      if (threadIdx.x == 0) {
        st_relaxed(scratch + t, kIncl << 62 | (before + agg));
      }
    }
    if (threadIdx.x == 0) s_before = before;
  }
  __syncthreads();
  int run = static_cast<int>(s_before) + excl;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (i0 + k <= n_lanes) starts[i0 + k] = run;
    run += v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint32_t* __restrict__ flat,
            const int* __restrict__ lane_words,
            const int* __restrict__ starts, uint32_t* __restrict__ out,
            int wb, int total, int n_flat) {
  const int s0 = blockIdx.x * kSpan;
  const unsigned long long recip = wb > 1 ? ~0ull / wb + 1 : 0;
  uint32_t v[kIters][kVec];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int slot = s0 + (it * kThreads + threadIdx.x) * kVec;
    const int lane = static_cast<int>(
        wb > 1 ? __umul64hi(static_cast<unsigned long long>(slot), recip)
               : slot);
    const int j = slot - lane * wb;
    const int lw = slot < total ? max(lane_words[lane], 0) : 0;
    const long long src = j < lw ? static_cast<long long>(starts[lane]) + j
                                 : 0;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      v[it][e] = j + e < lw && src + e < n_flat ? flat[src + e] : 0u;
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int slot = s0 + (it * kThreads + threadIdx.x) * kVec;
    if (slot < total) {
      *reinterpret_cast<uint4*>(out + slot) =
          make_uint4(v[it][0], v[it][1], v[it][2], v[it][3]);
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
  const int n_lanes = C * nl;
  const int n_tiles = (n_lanes + 1 + kScanTile - 1) / kScanTile;
  if (wb % 4 || total >= (1ll << 31) - kSpan ||
      scratch_words < n_tiles + 1 + (n_lanes + 2) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  uint64_t* status = static_cast<uint64_t*>(scratch);
  int* starts = reinterpret_cast<int*>(status + n_tiles + 1);
  cudaError_t err = cudaMemsetAsync(
      status, 0, (static_cast<size_t>(n_tiles) + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<n_tiles, kScanThreads, 0, s>>>(
      static_cast<const int*>(lane_words), status, starts, n_lanes, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_kernel<<<static_cast<int>((total + kSpan - 1) / kSpan), kThreads, 0,
                s>>>(static_cast<const uint32_t*>(flat),
                     static_cast<const int*>(lane_words), starts,
                     static_cast<uint32_t*>(out), wb,
                     static_cast<int>(total), n_flat);
  return static_cast<int>(cudaGetLastError());
}
