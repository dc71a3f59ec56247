// Rank arithmetic shared by the packed single-batch rank kernel
// (rank_packed.cu) and the query kernels (fm_query_packed.cu,
// fm_query_unpacked.cu, fm_query_stacked.cu, merge_walk.cu), so the
// popcount and ballot logic exists once, plus the SA-sample lookup of
// locate().  The unpacked single-batch kernel (rank_select.cu) counts in
// its own lane groups.
//
// Packed layout (sigma <= 16): a fused row is [Occ checkpoint (sigma words)
// | r/fpw words of 2- or 4-bit fields, LSB first].  Unpacked layout: blocks
// of r int32 symbols, checkpoints in a separate occ_samples[n_blocks + 1,
// sigma] array.  Every word is int32 storage read as uint32.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

constexpr int PAD = -1;          // query padding token
constexpr int CHUNK = 8;         // packed words loaded together

template <int BITS>
struct Packed {
  static constexpr int FPW = 32 / BITS;  // fields per word
  static constexpr uint32_t REP = BITS == 2 ? 0x55555555u : 0x11111111u;
  static constexpr uint32_t FIELD = (1u << BITS) - 1u;
};

// The LSB of every field of x that is zero, nothing else: XOR-ing a word
// with c replicated into every field leaves zero fields where c sits.
template <int BITS>
__device__ __forceinline__ uint32_t zero_fields(uint32_t x) {
  uint32_t t = x | (x >> 1);
  if (BITS == 4) t |= t >> 2;
  return (t & Packed<BITS>::REP) ^ Packed<BITS>::REP;
}

// Fields equal to c (pat = c * REP) in word w of a block, counting only
// the first `cut` fields of the block (full = cut / FPW whole words, then
// the `part` mask of the partial word).
template <int BITS>
__device__ __forceinline__ int word_count(uint32_t x, int w, uint32_t pat,
                                          int full, uint32_t part) {
  const uint32_t sel = w < full ? 0xFFFFFFFFu : (w == full ? part : 0u);
  return __popc(zero_fields<BITS>(x ^ pat) & sel);
}

template <int BITS>
__device__ __forceinline__ uint32_t part_mask(int cut) {
  return (1u << (BITS * (cut % Packed<BITS>::FPW))) - 1u;
}

// Count of c among the first `cut` fields of the W packed words at `words`.
// Each chunk of CHUNK words is loaded (predicated) before any is used, so a
// DNA row (W = 8 at r = 64) costs one memory round trip.
template <int BITS>
__device__ __forceinline__ int packed_count(const uint32_t* __restrict__ words,
                                            int W, uint32_t c, int cut) {
  const int full = cut / Packed<BITS>::FPW;
  const uint32_t part = part_mask<BITS>(cut), pat = c * Packed<BITS>::REP;
  int cnt = 0;
  for (int w0 = 0; w0 < W; w0 += CHUNK) {
    uint32_t x[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      x[i] = w0 + i < W ? __ldg(words + w0 + i) : 0u;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      cnt += word_count<BITS>(x[i], w0 + i, pat, full, part);
  }
  return cnt;
}

// Occ(c, blk * r + cut) over a fused row: checkpoint + in-block count.
template <int BITS>
__device__ __forceinline__ int packed_rank(const uint32_t* __restrict__ row,
                                           int sigma, int W, uint32_t c,
                                           int cut) {
  const int base = (int)__ldg(row + c);
  return base + packed_count<BITS>(row + sigma, W, c, cut);
}

// Counts of c among symbols [0, cuts[e]) of the N unpacked blocks blks[e]
// of r symbols, read cooperatively by this lane's group of G consecutive
// lanes (G divides 32): lane g of the group reads symbols g, g + G, ...
// (coalesced), four per lane and block loaded before the group votes with
// __ballot_sync.  Every lane of the warp must call it together with the
// same r; `live` = false lanes load nothing and vote no.
template <int G, int N>
__device__ __forceinline__ void group_counts(const int* const* blks,
                                             const int* cuts, int r, int c,
                                             bool live, int* cnt) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const uint32_t gmask =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & (32 - G));
#pragma unroll
  for (int e = 0; e < N; ++e) cnt[e] = 0;
  for (int j0 = 0; j0 < r; j0 += 4 * G) {
    int s[N][4];
    bool in[N][4];
#pragma unroll
    for (int e = 0; e < N; ++e) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i * G + g;
        in[e][i] = live && j < cuts[e] && j < r;
        s[e][i] = in[e][i] ? __ldg(blks[e] + j) : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cnt[e] += __popc(__ballot_sync(0xFFFFFFFFu, in[e][i] && s[e][i] == c)
                         & gmask);
    }
  }
}

// The SA sample of locate(): rows whose SA value is a multiple of `rate`
// are marked in `marks` (per-word exclusive popcounts in `mark_ranks`);
// their values sit in row order in `vals`, raw int32 (val_bits = 0) or
// bit-packed as value / rate at val_bits bits (n_vals words incl. a guard).
// `off` shifts the value index: a stacked catalog's segment reads its own
// slice of one value stream (raw values only), the clamp staying global.
struct SaSample {
  const uint32_t* marks;
  const int* mark_ranks;
  const uint32_t* vals;
  long long n_vals;
  int rate;
  int val_bits;
  long long off;
};

// The sampled SA value of a marked row whose mark word is `mw` and mark
// rank `mr` (bit b = row % 32).  Bit positions are 64-bit: at n = 2^28 the
// packed stream passes 2^31 bits.
__device__ __forceinline__ int sa_value(const SaSample& sa, uint32_t mw,
                                        int mr, int b) {
  const int idx = mr + __popc(mw & ((1u << b) - 1u));
  if (!sa.val_bits)
    return (int)__ldg(sa.vals + min(max(sa.off + idx, 0LL), sa.n_vals - 1));
  const long long bp = (long long)idx * sa.val_bits;
  const long long w = min(max(bp >> 5, 0LL), (long long)sa.n_vals - 2);
  const int off = (int)(bp & 31);
  const uint32_t lo = __ldg(sa.vals + w) >> off;
  const uint32_t hi = off ? __ldg(sa.vals + w + 1) << (32 - off) : 0u;
  return (int)((lo | hi) & ((1u << sa.val_bits) - 1u)) * sa.rate;
}
