// Fused FM query over the unpacked layout (sigma > 16: proteins, bytes):
// the backward search of a whole (B, m) batch of PAD-padded patterns and,
// for locate (k > 0), the LF-walk of every candidate row to its SA sample,
// in one launch.
//
// Replaces: rank_select_pallas / _kernel,
//           src/repro/kernels/rank_select.py:170-201, as the JAX package
//           drives it from count / locate (src/repro/core/fm_index.py:369,
//           457): a lax.scan of m backward-search steps and a fori_loop of
//           sa_sample_rate walk steps, each a batched rank call plus the
//           checkpoint gather, compiled into one program per (B, m) bucket.
// Plain version: fm_query_unpacked_plain in
//           src/repro_torch/kernels/fm_query.py (the same step loop over
//           rank_select_plain).
//
// Bound on the H100: the dependent-load chain, not bytes.  A rank reads one
// checkpoint word and the block's symbols below the cut (at most r int32:
// 256 bytes at r = 64); a 1024-pattern bucket moves a few MB.  But each
// step needs the previous step's interval or row, so the time is the chain
// of random memory round trips: m search steps, then up to sa_sample_rate
// walk steps for locate.
//
// Design: lanes come in groups of 16 per pattern (k rounded up to a
// multiple of 16; one group for count).  Each group runs the pattern's
// search cooperatively, like rank_select.cu: lane g reads symbols g, g+16,
// ... of both interval ends' blocks (64-byte coalesced reads), all loads of
// a step in flight together with both checkpoint words, then the group
// votes with __ballot_sync.  Several groups of one pattern repeat the same
// search on the same addresses.  The walk is lane-serial: lane j walks row
// sp + j; a step issues the mark word, its rank, bwt[row] and the first 32
// symbols of the row's block together, then the checkpoint of c = bwt[row]
// beside the rest of the block (two round trips a step).  C sits in shared
// memory; every step's state stays in registers.  In a trial on the H100 a
// lane-serial search (each lane reading both blocks alone) was slower on
// every bucket than the group's ballot read.
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_query_common.cuh"

__global__ void fm_query_unpacked_kernel(UnpackedIndex ix,
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

  // -- locate: walk row sp + j to its nearest sampled row ----------------
  const int row = sp + j;
  pos_out[(size_t)b * k + j] = row < ep ? unpacked_walk(ix, sC, sa, row)
                                        : ix.n;
}

extern "C" int fm_query_unpacked_launch(
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
    fm_query_unpacked_kernel<<<grid, threads, (size_t)sigma * sizeof(int),
                               (cudaStream_t)stream>>>(
        ix, (const int*)C, sa, (const int*)patterns, B, m, k, lanes,
        (int*)sp, (int*)ep, (int*)pos);
  }
  return (int)cudaGetLastError();
}
