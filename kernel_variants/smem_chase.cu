// One dependent shared-memory access, measured: a single thread follows a
// cycle of indices through shared memory, each load's address the value of
// the load before it, as the FGK kernels' climbs follow parent slots
// (csrc/fgk.cu). chip_smoke.py builds this file with the package's nvcc
// flags, times two chase lengths with CUDA events (the difference over the
// extra steps is the time of one access, launch cost excluded) and reads
// the SM cycles of the longer one from clock64.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 4096;

__global__ void smem_chase(const int* __restrict__ next, int slots, int steps,
                           long long* __restrict__ out) {
  __shared__ int s[kMaxSlots];
  for (int i = threadIdx.x; i < slots; i += blockDim.x) s[i] = next[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int j = 0;
  const long long t0 = clock64();
  for (int k = 0; k < steps; ++k) j = s[j];
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = j;  // keeps the chain alive
}

}  // namespace

// next: (slots,) int32 on the device, a permutation of one cycle;
// out: (2,) int64, the cycles of the chase and its last index.
extern "C" int smem_chase_launch(const void* next, void* out, int slots,
                                 int steps, void* stream) {
  if (slots < 1 || slots > kMaxSlots || steps < 0) return cudaErrorInvalidValue;
  smem_chase<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), slots, steps,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
