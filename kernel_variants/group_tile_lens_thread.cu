// Design variant of csrc/group_tile_lens.cu: the first design of the
// group walk, one thread a group walking its
// bytes one at a time from global memory, each tile's size a dependent
// global load. Timed by time_walk_variants.py beside the package's warp
// design. Same contract and the same two instances as the package's
// kernel:
//
// Contract: stream (n,) u8 holds concatenated per-tile MNP-5 streams,
// `total` bytes in all; group_offs (ng,) i32 is the offset of every K-th
// tile's stream; sizes (ng * K,) i32 the decoded size of each tile (0 past
// the last tile) -> lens (ng * K,) i32, the bytes of each tile's stream,
// and decoded (ng * K,) i32, the bytes each tile's stream decodes to as
// walked: its size, more where a count byte overshoots it, less for a tile
// the group's bytes end inside, 0 for a tile never reached. A decoder
// holds decoded against sizes to refuse a broken stream; decoded may be
// null, and is then not written (an instance of its own, so the grouped
// manifest's walk keeps the stores of the lengths alone).
// A group is walked through the decoder FSM (match byte, count <= 3: the
// byte after three equal ones is a count byte and expands to that many
// repeats) for at most group_cap bytes; a tile ends where its decoded size
// is reached, and the FSM restarts there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <bool kDecoded>
__global__ void __launch_bounds__(kThreads)
group_tile_lens_kernel(const uint8_t* __restrict__ stream,
                       const int* __restrict__ group_offs,
                       const int* __restrict__ sizes, int* __restrict__ lens,
                       int* __restrict__ decoded, int ng, int K, int n,
                       int total, int group_cap) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= ng) return;
  const int off = group_offs[g];
  const int end = g + 1 < ng ? group_offs[g + 1] : total;
  const int glen = min(end - off, group_cap);
  const int* sz = sizes + static_cast<size_t>(g) * K;
  int* out = lens + static_cast<size_t>(g) * K;
  int* dec = kDecoded ? decoded + static_cast<size_t>(g) * K : nullptr;
  for (int k = 0; k < K; ++k) {
    out[k] = 0;
    if (kDecoded) dec[k] = 0;
  }

  int t = 0, produced = 0, match = -1, count = 0, bytes = 0;
  for (int pos = 0; pos < glen && t < K; ++pos) {
    const int byte = stream[min(max(off + pos, 0), n - 1)];
    const bool is_cnt = count == 3;
    produced += is_cnt ? byte : 1;
    ++bytes;
    if (produced >= sz[t]) {  // tile complete: the FSM restarts
      if (kDecoded) dec[t] = produced;
      out[t++] = bytes;
      produced = 0;
      bytes = 0;
      match = -1;
      count = 0;
    } else if (is_cnt) {
      count = 0;
    } else {
      count = match == byte ? count + 1 : 1;
      match = byte;
    }
  }
  if (t < K) {
    out[t] = bytes;
    if (kDecoded) dec[t] = produced;
  }
}

}  // namespace

extern "C" int group_tile_lens_launch(const void* stream,
                                      const void* group_offs,
                                      const void* sizes, void* lens,
                                      void* decoded, int ng, int K, int n,
                                      int total, int group_cap,
                                      void* cuda_stream) {
  const int blocks = (ng + kThreads - 1) / kThreads;
  auto kernel = decoded ? group_tile_lens_kernel<true>
                        : group_tile_lens_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream),
      static_cast<const int*>(group_offs), static_cast<const int*>(sizes),
      static_cast<int*>(lens), static_cast<int*>(decoded), ng, K, n, total,
      group_cap);
  return static_cast<int>(cudaGetLastError());
}
