// Design variant of csrc/group_tile_lens.cu: one instance that always
// stores each tile's decoded size beside its length (the first design of
// the second output). Timed by time_walk_variants.py beside the package's
// two instances: the stores cost the grouped manifest's walk, which does
// not read them, 7-10%, so the package keeps an instance without them.
// Same contract as the package's kernel, decoded never null.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

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
  int* dec = decoded + static_cast<size_t>(g) * K;
  for (int k = 0; k < K; ++k) out[k] = dec[k] = 0;

  int t = 0, produced = 0, match = -1, count = 0, bytes = 0;
  for (int pos = 0; pos < glen && t < K; ++pos) {
    const int byte = stream[min(max(off + pos, 0), n - 1)];
    const bool is_cnt = count == 3;
    produced += is_cnt ? byte : 1;
    ++bytes;
    if (produced >= sz[t]) {  // tile complete: the FSM restarts
      dec[t] = produced;
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
    dec[t] = produced;
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
  group_tile_lens_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream),
      static_cast<const int*>(group_offs), static_cast<const int*>(sizes),
      static_cast<int*>(lens), static_cast<int*>(decoded), ng, K, n, total,
      group_cap);
  return static_cast<int>(cudaGetLastError());
}
