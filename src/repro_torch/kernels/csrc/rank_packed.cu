// Packed rank: Occ(c, blk*r + cut) over the fused [Occ checkpoint | packed
// 2/4-bit words] rows of the FM-index (sigma <= 16, e.g. DNA).
//
// Replaces: rank_packed_pallas / _packed_kernel,
//           src/repro/kernels/rank_select.py:104-161.
// Plain version: rank_packed_plain in src/repro_torch/kernels/rank_select.py.
//
// Bound on the H100: bytes.  A query reads the checkpoint word of c and the
// packed words up to its cutoff word (at most 1 + r*bits/32 of the row's
// sigma + r*bits/32 words: 9 of 15 for DNA at r=64, 4-bit) plus 12 bytes of
// arguments, and writes 4 bytes: under 100 bytes for DNA, so a batch of
// 2*1024 queries is well under 0.1 us of HBM time at 3.35 TB/s and at
// serving batch sizes the kernel is launch-bound.
//
// Design: the TPU kernel held the whole fused array in VMEM; at corpus
// scale it is ~250 MB here, far beyond shared memory, so each query gets
// one thread that gathers its own row from global memory / L2.  The row's
// words are XOR-ed against c replicated into every field, a per-field zero
// test leaves the LSB of each matching field set, the cutoff mask keeps the
// fields below the cut, __popc counts them, and the checkpoint row[c] is
// added (packed_rank in rank_common.cuh, shared with fm_query_packed.cu).
// No shared memory, no synchronisation.  The serving path no longer calls
// this kernel once per pattern position: fm_query_packed.cu answers a whole
// batch in one launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_common.cuh"

template <int BITS>
__global__ void rank_packed_kernel(const uint32_t* __restrict__ fused,
                                   int wid, int sigma,
                                   const int* __restrict__ blk,
                                   const int* __restrict__ sym,
                                   const int* __restrict__ cut,
                                   int* __restrict__ out, int B) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const uint32_t* row = fused + (size_t)blk[q] * (size_t)wid;
  out[q] = packed_rank<BITS>(row, sigma, wid - sigma, (uint32_t)sym[q], cut[q]);
}

extern "C" int rank_packed_launch(const void* fused, int wid, int sigma,
                                  int bits, const void* blk, const void* sym,
                                  const void* cut, void* out, int B,
                                  void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int grid = (B + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    if (bits == 2)
      rank_packed_kernel<2><<<grid, threads, 0, st>>>(
          (const uint32_t*)fused, wid, sigma, (const int*)blk,
          (const int*)sym, (const int*)cut, (int*)out, B);
    else
      rank_packed_kernel<4><<<grid, threads, 0, st>>>(
          (const uint32_t*)fused, wid, sigma, (const int*)blk,
          (const int*)sym, (const int*)cut, (int*)out, B);
  }
  return (int)cudaGetLastError();
}
