// Per-tile 256-bin histograms of the 8-bit digit (key >> shift) & 0xFF:
// the counting pass of the LSD radix local sort.
//
// Replaces: radix_hist_pallas / _kernel,
//           src/repro/kernels/radix_hist.py:18-45.
// Plain version: radix_hist_plain in src/repro_torch/kernels/radix_hist.py.
//
// Layout: the counts are written digit-major, hist[digit * ntiles + tile],
// so the exclusive scan in (digit, tile) order that turns them into bin
// bases runs over contiguous memory with no transpose.  The wrapper returns
// the transposed view, whose values are the JAX layout (ntiles, 256).
//
// Bound on the H100: bytes.  Each key is read once (4n bytes) and each tile
// writes 256 counts (1 KiB per tile: n/8 bytes at the sort engine's
// 8192-key tiles): 4.125n bytes, about 0.33 ms at n = 2^28 and 3.35 TB/s.
//
// Design: the TPU kernel compared a (block, 256) one-hot in VMEM.  Here one
// CUDA block of 256 threads takes one tile (block = 1024 or 8192 keys),
// eight coalesced key loads in flight per thread.  A count does not depend
// on order, so shared-memory atomics are correct.  Each warp counts into a
// sub-histogram of its own (8 x 256 ints), so warps never contend; inside
// a warp, lanes with the same digit hit one address and serialise, so a
// warp whose 32 lanes all hold one digit (a sorted run, a constant key
// word) adds 32 once.  The sub-histograms are summed into the tile's row.
// Tiles are independent, so the sequential TPU grid needs no carry here.
// (__match_any_sync aggregation, as char_histogram.cu does for its few
// bins, costs more here: its time grows with the number of distinct values
// in the warp, and 8-bit digits have up to 32.)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
    radix_hist_kernel(const uint32_t* __restrict__ keys, int shift, int block,
                      int ntiles, int* __restrict__ hist) {
  __shared__ int h[WARPS * 256];
  for (int i = threadIdx.x; i < WARPS * 256; i += THREADS) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int* mine = h + (threadIdx.x >> 5) * 256;
  const uint32_t* k = keys + (size_t)blockIdx.x * (size_t)block;
  for (int i0 = 0; i0 < block; i0 += THREADS * UNROLL) {
    uint32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      v[u] = i < block ? k[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      // block is a multiple of THREADS, so the guard is uniform per block
      if (i0 + u * THREADS < block) {
        const int d = (v[u] >> shift) & 0xFF;
        if (__all_sync(0xFFFFFFFFu, d == __shfl_sync(0xFFFFFFFFu, d, 0))) {
          if (lane == 0) atomicAdd(&mine[d], 32);
        } else {
          atomicAdd(&mine[d], 1);
        }
      }
    }
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) sum += h[w * 256 + threadIdx.x];
  hist[(size_t)threadIdx.x * ntiles + blockIdx.x] = sum;
}

}  // namespace

// hist: int32[256, n / block] (digit-major); block a multiple of 256
extern "C" int radix_hist_launch(const void* keys, int shift, int n,
                                 int block, void* hist, void* stream) {
  if (block <= 0 || block % THREADS || n % block) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    radix_hist_kernel<<<n / block, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)keys, shift, block, n / block, (int*)hist);
  }
  return (int)cudaGetLastError();
}
