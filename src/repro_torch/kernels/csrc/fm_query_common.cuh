// The per-lane body of the fused query kernels: one pattern's backward
// search and one candidate row's LF-walk to its SA sample, on the packed
// and on the unpacked layout.  The single-index kernels (fm_query_packed.cu,
// fm_query_unpacked.cu) and the stacked catalog's kernels
// (fm_query_stacked.cu) all compile from these bodies; a stacked kernel
// hands them one segment's slice of the bucket (PackedIndex /
// UnpackedIndex / SaSample built per block), so a segment's answers are
// those of its own index.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_common.cuh"

// -- packed layout (sigma <= 16, 2- or 4-bit fields) ------------------------

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

// (sp, ep) of the m-symbol pattern at `pat`, right to left (PADs on the
// right come first); the next symbol is prefetched one step ahead.
template <int BITS>
__device__ __forceinline__ void packed_search(const PackedIndex& ix,
                                              const int* sC, const int* pat,
                                              int m, int& sp, int& ep) {
  sp = 0;
  ep = ix.n;
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
}

// The text position of row `row` (< n): walk it to its nearest sampled row.
template <int BITS>
__device__ __forceinline__ int packed_walk(const PackedIndex& ix,
                                           const int* sC, const SaSample& sa,
                                           int row) {
  int pos = 0;                      // no sample within the stride: 0
  for (int steps = 0; steps < sa.rate; ++steps) {
    const int w = row >> 5, bit = row & 31;
    const uint32_t mw = __ldg(sa.marks + w);
    const int mr = __ldg(sa.mark_ranks + w);
    const int next = lf_step<BITS>(ix, sC, row);
    const bool marked = (mw >> bit) & 1u;
    row = marked ? row : next;      // a select: the row's loads stay
    if (marked) {                   // issued beside the mark word's
      pos = sa_value(sa, mw, mr, bit) + steps;
      break;
    }
  }
  return pos;
}

// -- unpacked layout (sigma > 16) -------------------------------------------

constexpr int GROUP = 16;        // lanes that share one search
constexpr int SPAN = 32;         // block symbols a walk lane loads together

struct UnpackedIndex {
  const int* bwt;   // [n_blocks * r]
  const int* occ;   // [n_blocks (+ 1), sigma]
  int sigma, n_blocks, r, n;
};

// LF(row) = C[c] + Occ(c, row) with c = bwt[row] (row < n: no clamp).
__device__ __forceinline__ int lf_step(const UnpackedIndex& ix, const int* sC,
                                       int row) {
  const int blk = row / ix.r, cut = row - blk * ix.r;
  const int* bp = ix.bwt + (size_t)blk * ix.r;
  int s[SPAN];
#pragma unroll
  for (int i = 0; i < SPAN; ++i) s[i] = i < cut ? __ldg(bp + i) : 0;
  const int c = __ldg(bp + cut);
  const int base = __ldg(ix.occ + (size_t)blk * ix.sigma + c);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < SPAN; ++i) cnt += i < cut && s[i] == c;
  for (int j0 = SPAN; j0 < cut; j0 += SPAN) {
#pragma unroll
    for (int i = 0; i < SPAN; ++i)
      s[i] = j0 + i < cut ? __ldg(bp + j0 + i) : 0;
#pragma unroll
    for (int i = 0; i < SPAN; ++i) cnt += j0 + i < cut && s[i] == c;
  }
  return sC[c] + base + cnt;
}

// (sp, ep) of the m-symbol pattern at `pat`, searched cooperatively by
// this lane's group of GROUP lanes (every lane of the warp must call it).
__device__ __forceinline__ void unpacked_search(const UnpackedIndex& ix,
                                                const int* sC, const int* pat,
                                                int m, int& sp, int& ep) {
  sp = 0;
  ep = ix.n;
  int cn = m > 0 ? __ldg(pat + m - 1) : PAD;
  for (int q = m - 1; q >= 0; --q) {
    const int c = cn;
    if (q > 0) cn = __ldg(pat + q - 1);
    const bool in_alphabet = c >= 1 && c < ix.sigma;
    const bool valid = in_alphabet && ep > sp;
    const int b0 = min(sp / ix.r, ix.n_blocks - 1);
    const int b1 = min(ep / ix.r, ix.n_blocks - 1);
    const int* blks[2] = {ix.bwt + (size_t)b0 * ix.r,
                          ix.bwt + (size_t)b1 * ix.r};
    const int cuts[2] = {sp - b0 * ix.r, ep - b1 * ix.r};
    const int base0 = valid ? __ldg(ix.occ + (size_t)b0 * ix.sigma + c) : 0;
    const int base1 = valid ? __ldg(ix.occ + (size_t)b1 * ix.sigma + c) : 0;
    int cnt[2];
    group_counts<GROUP, 2>(blks, cuts, ix.r, c, valid, cnt);
    if (valid) {
      sp = sC[c] + base0 + cnt[0];
      ep = sC[c] + base1 + cnt[1];
    } else if (c != PAD && !in_alphabet) {
      ep = sp;                      // unknown symbol: empty interval
    }
  }
}

// The text position of row `row` (< n), walked lane-serially.
__device__ __forceinline__ int unpacked_walk(const UnpackedIndex& ix,
                                             const int* sC,
                                             const SaSample& sa, int row) {
  int pos = 0;                      // no sample within the stride: 0
  for (int steps = 0; steps < sa.rate; ++steps) {
    const int w = row >> 5, bit = row & 31;
    const uint32_t mw = __ldg(sa.marks + w);
    const int mr = __ldg(sa.mark_ranks + w);
    const int next = lf_step(ix, sC, row);
    const bool marked = (mw >> bit) & 1u;
    row = marked ? row : next;      // a select: the block's loads stay
    if (marked) {                   // issued beside the mark word's
      pos = sa_value(sa, mw, mr, bit) + steps;
      break;
    }
  }
  return pos;
}
