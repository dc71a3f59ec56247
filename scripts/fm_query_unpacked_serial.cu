// The fused unpacked query kernel as it was before its redesign for the
// english index (sigma 258): groups of 16 lanes a pattern, each group
// running the pattern's backward search with group_counts' ballots, and a
// lane-serial walk (lane j walks row sp + j alone, its block's symbols as
// separate 4-byte loads, fm_query_common.cuh's unpacked_walk).
// chip_smoke.py builds it (nvcc, plain C interface, ctypes) beside the
// port's kernels and times it in turns with
// src/repro_torch/kernels/csrc/fm_query_unpacked.cu on the same batches,
// so the redesign is measured against it within one run.  It is a
// measurement, not a kernel of the port: no wrapper calls it and no launch
// of it is counted.  Its entry takes the arguments the port's entry took
// before the redesign.
#include <cstdint>
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/fm_query_common.cuh"

__global__ void fm_query_unpacked_serial_kernel(UnpackedIndex ix,
                                                const int* __restrict__ C,
                                                SaSample sa,
                                                const int* __restrict__ patterns,
                                                int B, int m, int k, int lanes,
                                                int* __restrict__ sp_out,
                                                int* __restrict__ ep_out,
                                                int* __restrict__ pos_out) {
  extern __shared__ int sC[];
  for (int i = threadIdx.x; i < ix.sigma; i += blockDim.x) sC[i] = C[i];
  __syncthreads();
  // every lane of a warp takes part in the search's votes; lanes past the
  // batch search pattern B - 1 and write nothing
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < (long long)B * lanes;
  const int b = active ? (int)(t / lanes) : B - 1;
  const int j = active ? (int)(t - (long long)b * lanes) : lanes;

  int sp, ep;
  unpacked_search(ix, sC, patterns + (size_t)b * m, m, sp, ep);
  if (active && j == 0) {
    sp_out[b] = sp;
    ep_out[b] = ep;
  }
  if (j >= k) return;               // count (k = 0), spare lanes, the tail

  const int row = sp + j;
  pos_out[(size_t)b * k + j] = row < ep ? unpacked_walk(ix, sC, sa, row)
                                        : ix.n;
}

extern "C" int fm_query_unpacked_serial_launch(
    const void* bwt, const void* occ, int n_blocks, int sigma, int r, int n,
    const void* C, const void* marks, const void* mark_ranks,
    const void* vals, int n_vals, int sa_rate, int val_bits,
    const void* patterns, int B, int m, int k, void* sp, void* ep, void* pos,
    void* stream) {
  if (B > 0) {
    UnpackedIndex ix{(const int*)bwt, (const int*)occ, sigma, n_blocks, r, n};
    SaSample sa{(const uint32_t*)marks, (const int*)mark_ranks,
                (const uint32_t*)vals, n_vals, sa_rate, val_bits, 0};
    const int lanes = (k > 0 ? (k + GROUP - 1) / GROUP : 1) * GROUP;
    const int threads = 128;
    const long long total = (long long)B * lanes;
    const unsigned grid = (unsigned)((total + threads - 1) / threads);
    fm_query_unpacked_serial_kernel<<<grid, threads,
                                      (size_t)sigma * sizeof(int),
                                      (cudaStream_t)stream>>>(
        ix, (const int*)C, sa, (const int*)patterns, B, m, k, lanes,
        (int*)sp, (int*)ep, (int*)pos);
  }
  return (int)cudaGetLastError();
}
