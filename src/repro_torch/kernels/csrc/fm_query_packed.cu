// Fused FM query over the packed layout (sigma <= 16, 2- or 4-bit fields;
// DNA): the backward search of a whole (B, m) batch of PAD-padded patterns
// and, for locate (k > 0), the LF-walk of every candidate row to its SA
// sample, in one launch.
//
// Replaces: rank_packed_pallas / _packed_kernel,
//           src/repro/kernels/rank_select.py:104-161, as the JAX package
//           drives it from count / locate (src/repro/core/fm_index.py:369,
//           457): a lax.scan of m backward-search steps and a fori_loop of
//           sa_sample_rate walk steps, each a batched rank call, compiled
//           into one program per (B, m) bucket.
// Plain version: fm_query_packed_plain in src/repro_torch/kernels/fm_query.py
//           (the same step loop over rank_packed_plain).
//
// Bound on the H100: the dependent-load chain, not bytes.  A query touches
// one fused row (sigma + r*bits/32 words, 60 bytes for DNA at r = 64) per
// interval end per pattern position, and per walk step one row, one mark
// word and rank, and finally one value: a 1024-pattern bucket moves a few
// MB (microseconds at 3.35 TB/s).  But each step needs the previous step's
// row, and at DNA 2^28 the 252 MB fused array is far beyond the 50 MB L2,
// so every step is a random HBM round trip: m steps for count, up to
// m + sa_sample_rate for locate.
//
// Design: one thread per (pattern, slot) lane, max(k, 1) lanes per pattern;
// every step's state stays in registers and nothing goes back to the host
// between steps.  The lanes of a pattern run its search redundantly: their
// loads hit the same addresses and merge into one request.  A search step
// issues both interval ends' checkpoint word and all their packed words
// before using any (one round trip per step; the cutoff mask drops the
// fields past the cut); the next pattern symbol is prefetched one step
// ahead.  A walk step issues the mark word, its rank, every checkpoint
// word of the row and its packed words together: bwt[row] is field row % r
// of that same row, so Occ(bwt[row], row) needs no second fetch.  C sits
// in shared memory.  Lane j of pattern b walks row sp + j; rows at or past
// ep write n.  Trials of loading only the words below the cut, and of 32-
// or 64-thread blocks in place of 128, did not make it faster on the H100.
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_query_common.cuh"

template <int BITS>
__global__ void fm_query_packed_kernel(PackedIndex ix,
                                       const int* __restrict__ C,
                                       SaSample sa,
                                       const int* __restrict__ patterns,
                                       int B, int m, int k,
                                       int* __restrict__ sp_out,
                                       int* __restrict__ ep_out,
                                       int* __restrict__ pos_out) {
  extern __shared__ int sC[];
  for (int i = threadIdx.x; i < ix.sigma; i += blockDim.x) sC[i] = C[i];
  __syncthreads();
  const int lanes = max(k, 1);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * lanes) return;
  const int b = (int)(t / lanes), j = (int)(t - (long long)b * lanes);

  int sp, ep;
  packed_search<BITS>(ix, sC, patterns + (size_t)b * m, m, sp, ep);
  if (j == 0) {
    sp_out[b] = sp;
    ep_out[b] = ep;
  }
  if (k == 0) return;

  // -- locate: walk row sp + j to its nearest sampled row ----------------
  const int row = sp + j;
  pos_out[(size_t)b * k + j] =
      row < ep ? packed_walk<BITS>(ix, sC, sa, row) : ix.n;
}

extern "C" int fm_query_packed_launch(
    const void* fused, int wid, int n_blocks, int sigma, int bits, int r,
    int n, const void* C, const void* marks, const void* mark_ranks,
    const void* vals, int n_vals, int sa_rate, int val_bits,
    const void* patterns, int B, int m, int k, void* sp, void* ep, void* pos,
    void* stream) {
  if (B > 0) {
    PackedIndex ix{(const uint32_t*)fused, wid, sigma, wid - sigma,
                   n_blocks, r, n};
    SaSample sa{(const uint32_t*)marks, (const int*)mark_ranks,
                (const uint32_t*)vals, n_vals, sa_rate, val_bits, 0};
    const int threads = 128;
    const long long total = (long long)B * (k > 0 ? k : 1);
    const unsigned grid = (unsigned)((total + threads - 1) / threads);
    const size_t smem = (size_t)sigma * sizeof(int);
    cudaStream_t st = (cudaStream_t)stream;
    if (bits == 2)
      fm_query_packed_kernel<2><<<grid, threads, smem, st>>>(
          ix, (const int*)C, sa, (const int*)patterns, B, m, k, (int*)sp,
          (int*)ep, (int*)pos);
    else
      fm_query_packed_kernel<4><<<grid, threads, smem, st>>>(
          ix, (const int*)C, sa, (const int*)patterns, B, m, k, (int*)sp,
          (int*)ep, (int*)pos);
  }
  return (int)cudaGetLastError();
}
