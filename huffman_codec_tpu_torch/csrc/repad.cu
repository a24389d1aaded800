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
// padded layout once. Design: one block per chunk. The chunk's first word
// is the sum of all earlier chunks' lane words (a block reduction over
// the manifest prefix, served from L2), its lane starts an exclusive scan
// of its own row; then consecutive threads write consecutive output slots,
// each reading its word from the same lane's contiguous run, so loads and
// stores both coalesce. (The TPU kernel's butterfly routing stands in for
// a scatter it does not have.)

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
repad_kernel(const uint32_t* __restrict__ flat,
             const int* __restrict__ lane_words, uint32_t* __restrict__ out,
             int nl, int wb, long long n_flat) {
  using Reduce = cub::BlockReduce<long long, kThreads>;
  __shared__ typename Reduce::TempStorage red_tmp;
  __shared__ long long chunk_base;
  extern __shared__ int start[];  // nl exclusive lane starts
  const int c = blockIdx.x;
  const int* lw = lane_words + static_cast<size_t>(c) * nl;

  long long s = 0;
  const long long prefix = static_cast<long long>(c) * nl;
  for (long long i = threadIdx.x; i < prefix; i += kThreads) s += lane_words[i];
  s = Reduce(red_tmp).Sum(s);
  if (threadIdx.x == 0) {
    chunk_base = s;
    int a = 0;
    for (int k = 0; k < nl; ++k) {
      start[k] = a;
      a += lw[k];
    }
  }
  __syncthreads();

  uint32_t* o = out + static_cast<size_t>(c) * nl * wb;
  const int slots = nl * wb;
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    const int k = i / wb;
    const int j = i - k * wb;
    const long long src = chunk_base + start[k] + j;
    o[i] = (j < lw[k] && src < n_flat) ? flat[src] : 0u;
  }
}

}  // namespace

extern "C" int repad_launch(const void* flat, const void* lane_words,
                            void* out, int C, int nl, int wb, int n_flat,
                            void* stream) {
  const size_t smem = static_cast<size_t>(nl) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  repad_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(flat), static_cast<const int*>(lane_words),
      static_cast<uint32_t*>(out), nl, wb, n_flat);
  return static_cast<int>(cudaGetLastError());
}
