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

#include "rank_common.cuh"

constexpr int MAX_SIGMA = 16;    // the packed layout's largest alphabet

struct PackedIndex {
  const uint32_t* fused;  // [n_blocks, wid]
  int wid, sigma, W, n_blocks, r, n;
};

// One backward-search step on both interval ends with symbol c in the
// alphabet: all loads of both rows are issued before any is used.
template <int BITS>
__device__ __forceinline__ void search_step(const PackedIndex& ix,
                                            const int* sC, int c, int& sp,
                                            int& ep) {
  const int b0 = min(sp / ix.r, ix.n_blocks - 1);
  const int b1 = min(ep / ix.r, ix.n_blocks - 1);
  const int cut0 = sp - b0 * ix.r, cut1 = ep - b1 * ix.r;
  const uint32_t* row0 = ix.fused + (size_t)b0 * ix.wid;
  const uint32_t* row1 = ix.fused + (size_t)b1 * ix.wid;
  const uint32_t pat = (uint32_t)c * Packed<BITS>::REP;
  const int full0 = cut0 / Packed<BITS>::FPW, full1 = cut1 / Packed<BITS>::FPW;
  const uint32_t part0 = part_mask<BITS>(cut0), part1 = part_mask<BITS>(cut1);
  const int base0 = (int)__ldg(row0 + c), base1 = (int)__ldg(row1 + c);
  int n0 = 0, n1 = 0;
  for (int w0 = 0; w0 < ix.W; w0 += CHUNK) {
    uint32_t x0[CHUNK], x1[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const bool in = w0 + i < ix.W;
      x0[i] = in ? __ldg(row0 + ix.sigma + w0 + i) : 0u;
      x1[i] = in ? __ldg(row1 + ix.sigma + w0 + i) : 0u;
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      n0 += word_count<BITS>(x0[i], w0 + i, pat, full0, part0);
      n1 += word_count<BITS>(x1[i], w0 + i, pat, full1, part1);
    }
  }
  sp = sC[c] + base0 + n0;
  ep = sC[c] + base1 + n1;
}

// LF(row) = C[c] + Occ(c, row) with c = bwt[row], from one fetch of the
// row (row < n, so its block needs no clamp).  The loads of the first
// chunk and of every checkpoint are in flight together; rows wider than
// CHUNK packed words load the rest afterwards.
template <int BITS>
__device__ __forceinline__ int lf_step(const PackedIndex& ix, const int* sC,
                                       int row) {
  const int blk = row / ix.r, cut = row - blk * ix.r;
  const uint32_t* rw = ix.fused + (size_t)blk * ix.wid;
  const int full = cut / Packed<BITS>::FPW;
  uint32_t ck[MAX_SIGMA], x[CHUNK];
#pragma unroll
  for (int i = 0; i < MAX_SIGMA; ++i)
    ck[i] = i < ix.sigma ? __ldg(rw + i) : 0u;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i)
    x[i] = i < ix.W ? __ldg(rw + ix.sigma + i) : 0u;
  const uint32_t sw = __ldg(rw + ix.sigma + full);   // the word holding c
  const uint32_t c =
      (sw >> (BITS * (cut % Packed<BITS>::FPW))) & Packed<BITS>::FIELD;
  const uint32_t pat = c * Packed<BITS>::REP, part = part_mask<BITS>(cut);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i)
    cnt += word_count<BITS>(x[i], i, pat, full, part);
  for (int w0 = CHUNK; w0 < ix.W; w0 += CHUNK) {
    uint32_t y[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      y[i] = w0 + i < ix.W ? __ldg(rw + ix.sigma + w0 + i) : 0u;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      cnt += word_count<BITS>(y[i], w0 + i, pat, full, part);
  }
  uint32_t base = 0;
#pragma unroll
  for (int i = 0; i < MAX_SIGMA; ++i)
    base = i == (int)c ? ck[i] : base;
  return sC[c] + (int)base + cnt;
}

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

  // -- backward search, right to left (PADs on the right come first) -----
  const int* pat = patterns + (size_t)b * m;
  int sp = 0, ep = ix.n;
  int cn = m > 0 ? __ldg(pat + m - 1) : PAD;
  for (int q = m - 1; q >= 0; --q) {
    const int c = cn;
    if (q > 0) cn = __ldg(pat + q - 1);
    const bool in_alphabet = c >= 1 && c < ix.sigma;
    if (in_alphabet && ep > sp)
      search_step<BITS>(ix, sC, c, sp, ep);
    else if (c != PAD && !in_alphabet)
      ep = sp;                      // unknown symbol: empty interval
  }
  if (j == 0) {
    sp_out[b] = sp;
    ep_out[b] = ep;
  }
  if (k == 0) return;

  // -- locate: walk row sp + j to its nearest sampled row ----------------
  int row = sp + j;
  int pos = 0;
  if (row < ep) {
    for (int steps = 0; steps < sa.rate; ++steps) {
      const int w = row >> 5, bit = row & 31;
      const uint32_t mw = __ldg(sa.marks + w);
      const int mr = __ldg(sa.mark_ranks + w);
      const int next = lf_step<BITS>(ix, sC, row);
      const bool marked = (mw >> bit) & 1u;
      row = marked ? row : next;     // a select: the row's loads stay
      if (marked) {                  // issued beside the mark word's
        pos = sa_value(sa, mw, mr, bit) + steps;
        break;
      }
    }
  } else {
    pos = ix.n;
  }
  pos_out[(size_t)b * k + j] = pos;
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
                (const uint32_t*)vals, n_vals, sa_rate, val_bits};
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
