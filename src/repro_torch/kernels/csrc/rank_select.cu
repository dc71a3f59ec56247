// Unpacked in-block rank: count of c among the first `cut` int32 symbols of
// block `blk` (sigma > 16: proteins, bytes).  The caller adds the Occ
// checkpoint (src/repro_torch/core/fm_index.py occ_batch).
//
// Replaces: rank_select_pallas / _kernel,
//           src/repro/kernels/rank_select.py:170-201.
// Plain version: rank_select_plain in src/repro_torch/kernels/rank_select.py.
//
// Bound on the H100: bytes.  A query reads the int32 symbols of its block
// below its cut (at most r: 256 bytes at r=64, in 32-byte sectors) plus 12
// bytes of arguments and a 4-byte result; at serving batch sizes the kernel
// is launch-bound.
//
// Design: the TPU kernel ran one query per grid step over a block fetched
// by scalar prefetch.  Here a warp answers one query: each lane loads
// symbols of 32-symbol slices (coalesced 128-byte transactions, four
// slices in flight), the warp votes with __ballot_sync on (symbol == c and
// position < cut), and __popc of the vote adds the slice's count
// (group_counts in rank_common.cuh, shared with fm_query_unpacked.cu).  The
// serving path no longer calls this kernel once per pattern position:
// fm_query_unpacked.cu answers a whole batch in one launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_common.cuh"

__global__ void rank_select_kernel(const int* __restrict__ blocks, int r,
                                   const int* __restrict__ blk,
                                   const int* __restrict__ sym,
                                   const int* __restrict__ cut,
                                   int* __restrict__ out, int B) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = (int)(gtid >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;  // uniform per warp: blockDim is a multiple of 32
  const int* row = blocks + (size_t)blk[q] * (size_t)r;
  const int* blks[1] = {row};
  const int cuts[1] = {min(cut[q], r)};
  int cnt[1];
  group_counts<32, 1>(blks, cuts, r, sym[q], true, cnt);
  if (lane == 0) out[q] = cnt[0];
}

extern "C" int rank_select_launch(const void* blocks, int r, const void* blk,
                                  const void* sym, const void* cut, void* out,
                                  int B, void* stream) {
  if (B > 0) {
    const int threads = 256;  // 8 queries per block
    const long long total = (long long)B * 32;
    rank_select_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, (cudaStream_t)stream>>>(
        (const int*)blocks, r, (const int*)blk, (const int*)sym,
        (const int*)cut, (int*)out, B);
  }
  return (int)cudaGetLastError();
}
