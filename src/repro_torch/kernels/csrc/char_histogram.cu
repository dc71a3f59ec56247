// Token histogram: counts[c] = number of i with tokens[i] == c, for c in
// [0, sigma).  Values outside [0, sigma) count nowhere.  The paper's Init
// map/reduce (the C array of the FM index, the seed builder's Occ init).
//
// Replaces: char_histogram_pallas / _kernel,
//           src/repro/kernels/char_histogram.py:18-52 (wrapper
//           ops.py:35-53, which pads with the out-of-range value sigma).
// Plain version: char_histogram_plain in
//           src/repro_torch/kernels/char_histogram.py.
//
// Bound on the H100: bytes.  Each token is read once (4n bytes; the sigma
// counts are noise): about 0.32 ms at n = 2^28 and 3.35 TB/s.
//
// Design: the TPU kernel summed a (rows*128, sigma) one-hot per grid step
// into one output block that the sequential grid revisits.  On the card a
// count does not depend on order, so atomics are correct; the hazard is
// contention: at sigma = 7 (DNA) every thread of the card would hit one of
// seven counters.  So each warp first groups its lanes by value with
// __match_any_sync and only the lowest lane of each group adds the group's
// size to a per-block histogram in shared memory (at most sigma shared
// atomics per warp step instead of 32); each block then adds its non-zero
// bins to the global counts, one atomic per bin per block.  A grid of at
// most 1024 blocks strides over the tokens, four coalesced loads in flight
// per thread.  Out-of-range lanes and the tail join the vote with value -1
// and are never counted, so every lane of a warp runs every step.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int MAX_BLOCKS = 1024;

__global__ void char_histogram_kernel(const int* __restrict__ tokens, int n,
                                      int sigma, int* __restrict__ counts) {
  extern __shared__ int h[];
  for (int b = threadIdx.x; b < sigma; b += THREADS) h[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * TILE;
  for (long long base = (long long)blockIdx.x * TILE; base < n;
       base += stride) {
    int v[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = base + k * THREADS + threadIdx.x;
      v[k] = i < n ? tokens[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool ok = (unsigned)v[k] < (unsigned)sigma;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, ok ? v[k] : -1);
      if (ok && (__ffs(peers) - 1) == lane) atomicAdd(&h[v[k]], __popc(peers));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < sigma; b += THREADS)
    if (h[b]) atomicAdd(&counts[b], h[b]);
}

}  // namespace

// counts: int32[sigma], zeroed by the caller; sigma * 4 bytes of shared
// memory per block (the wrapper keeps sigma <= 12288, under the 48 KiB
// that needs no opt-in)
extern "C" int char_histogram_launch(const void* tokens, int n, int sigma,
                                     void* counts, void* stream) {
  if (n <= 0 || sigma <= 0) return (int)cudaErrorInvalidValue;
  long long tiles = ((long long)n + TILE - 1) / TILE;
  const int blocks = (int)(tiles < MAX_BLOCKS ? tiles : MAX_BLOCKS);
  char_histogram_kernel<<<blocks, THREADS, sigma * sizeof(int),
                          (cudaStream_t)stream>>>((const int*)tokens, n,
                                                  sigma, (int*)counts);
  return (int)cudaGetLastError();
}
