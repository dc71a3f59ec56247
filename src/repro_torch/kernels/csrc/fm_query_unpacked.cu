// Fused FM query over the unpacked layout (sigma > 16: proteins, bytes,
// the english index at sigma 258): the backward search of a whole (B, m)
// batch of PAD-padded patterns and, for locate (k > 0), the LF-walk of
// every candidate row to its SA sample, in one launch.
//
// Replaces: rank_select_pallas / _kernel,
//           src/repro/kernels/rank_select.py:170-201, as the JAX package
//           drives it from count / locate (src/repro/core/fm_index.py:370,
//           458): a lax.scan of m backward-search steps and a fori_loop of
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
// walk steps (two round trips each: the symbol, then its checkpoint) for
// locate.
//
// Design: a group of G = 8 lanes works on one unit: a pattern's search
// (count), or one candidate row of a pattern (locate; k units a pattern).
// Lane g of a group loads the 16-byte chunks g and G + g of each
// 64-symbol step of a block (int4 __ldg where the blocks are 16-byte
// aligned and r % 4 == 0, the same chunks symbol by symbol otherwise),
// only where a chunk's first symbol lies below the cut, and the group
// sums its lanes' counts of c with three __shfl_xor_sync over its own
// lanes.  A walk step at r <= 64 is one request of the group for the
// block's lines up to the row (its symbol c shuffled from the lane that
// loaded it) beside the mark word and rank, then C[c] and the checkpoint
// occ[blk * sigma + c]: two round trips and the lines of one block a
// step.  The design before this one walked each row with one lane, whose
// 4-byte loads touched a line of their own for every lane of a warp, up
// to 64 such loads a step (scripts/fm_query_unpacked_serial.cu, timed in
// turns by chip_smoke.py).  A search step is the same instructions for
// every group of a warp (its loads predicated on the group's interval),
// so patterns of different lengths do not split a warp.  A block of
// THREADS holds PER = THREADS / G units, a tile of consecutive (pattern,
// row) units; group i of a tile searches the tile's i-th pattern and
// hands (sp, ep) to the tile's other groups through shared memory, so a
// pattern is searched once a tile.  The grid is at most one resident
// wave (fm_query.unpacked_plan, from fm_query_unpacked_occupancy, asked
// once per card); blocks stride over the tiles beyond it.  (16 lanes a
// unit, and every group repeating its pattern's search, were measured on
// the H100 in chip_smoke's phase 16 and were no faster: PERF.md.)
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_query_common.cuh"

constexpr int THREADS = 128;  // threads a block: 4 warps
constexpr int G = 8;          // lanes a unit
constexpr int PER = THREADS / G;  // units a tile

// Chunk j .. j + 3 of a block, only where j lies below `lim`: one 16-byte
// load (VEC: the block 16-byte aligned, j % 4 == 0, j + 3 < r), or the
// symbols below `lim` one by one.
template <bool VEC>
__device__ __forceinline__ int4 load_chunk(const int* __restrict__ blk,
                                           int j, int lim) {
  int4 x = make_int4(0, 0, 0, 0);
  if (VEC) {
    if (j < lim) x = __ldg(reinterpret_cast<const int4*>(blk + j));
  } else {
    if (j < lim) x.x = __ldg(blk + j);
    if (j + 1 < lim) x.y = __ldg(blk + j + 1);
    if (j + 2 < lim) x.z = __ldg(blk + j + 2);
    if (j + 3 < lim) x.w = __ldg(blk + j + 3);
  }
  return x;
}

// The block of position p: a shift where r is a power of two (rs = log2 r,
// else -1), a division otherwise.
__device__ __forceinline__ int block_of(int p, int r, int rs) {
  return rs >= 0 ? p >> rs : p / r;
}

// Symbols of the chunk x (j .. j + 3) equal to c and below the cut.
__device__ __forceinline__ int chunk_count(int4 x, int j, int c, int cut) {
  return (j < cut && x.x == c) + (j + 1 < cut && x.y == c) +
         (j + 2 < cut && x.z == c) + (j + 3 < cut && x.w == c);
}

// The sum of v over the group's lanes (gmask), in every lane: log2 G
// shuffles.  (A ballot or __reduce_add_sync over a partial mask
// serialises the groups of a warp: scripts/fm_query_unpacked_stamps.cu,
// scripts/rank_select_stamps.cu.)
__device__ __forceinline__ int group_sum(int v, uint32_t gmask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(gmask, v, o);
  return v;
}

// Occ(c, cut) inside the block at `blk` (the checkpoint not included),
// counted by this lane's group: lane g loads chunks 4g and 4(G + g) of
// each 8G-symbol step, both issued before either is used.  `cut` is the
// group's own (every lane of the group calls it with the same values).
template <bool VEC>
__device__ __forceinline__ int group_count(const int* __restrict__ blk,
                                           int c, int cut, uint32_t gmask,
                                           int g) {
  int cnt = 0;
  for (int j0 = 0; j0 < cut; j0 += 8 * G) {
    const int ja = j0 + 4 * g, jb = j0 + 4 * (G + g);
    const int4 xa = load_chunk<VEC>(blk, ja, cut);
    const int4 xb = load_chunk<VEC>(blk, jb, cut);
    cnt += chunk_count(xa, ja, c, cut) + chunk_count(xb, jb, c, cut);
  }
  return group_sum(cnt, gmask);
}

// Both interval ends of one search step: the counts of c below cut0 in
// blk0 and below cut1 in blk1 (r < 2^16), every chunk of a step in flight
// together.  The loop runs over the whole block (r, the same for every
// group), so the groups of a warp stay on one path whatever their cuts.
template <bool VEC>
__device__ __forceinline__ void group_count2(const int* __restrict__ blk0,
                                             int cut0,
                                             const int* __restrict__ blk1,
                                             int cut1, int c, int r, int g,
                                             uint32_t gmask, int& n0,
                                             int& n1) {
  n0 = n1 = 0;
  for (int j0 = 0; j0 < r; j0 += 8 * G) {
    const int ja = j0 + 4 * g, jb = j0 + 4 * (G + g);
    const int4 xa = load_chunk<VEC>(blk0, ja, cut0);
    const int4 xb = load_chunk<VEC>(blk0, jb, cut0);
    const int4 ya = load_chunk<VEC>(blk1, ja, cut1);
    const int4 yb = load_chunk<VEC>(blk1, jb, cut1);
    n0 += chunk_count(xa, ja, c, cut0) + chunk_count(xb, jb, c, cut0);
    n1 += chunk_count(ya, ja, c, cut1) + chunk_count(yb, jb, c, cut1);
  }
  // one shuffle chain for both ends: each count is below 2^16 (at most r)
  const unsigned both =
      (unsigned)group_sum((int)((unsigned)n0 | ((unsigned)n1 << 16)), gmask);
  n0 = (int)(both & 0xFFFFu);
  n1 = (int)(both >> 16);
}

// (sp, ep) of the m-symbol pattern at `pat`, right to left (PADs on the
// right come first), searched by this lane's group; each step's
// checkpoints and C[c] are loaded beside the blocks.  A step is the same
// instructions for every group of a warp, its loads predicated on the
// group's interval (a PAD, an empty interval or an unknown symbol loads
// nothing), so groups whose patterns differ in length do not diverge.
template <bool VEC>
__device__ __forceinline__ void group_search(const UnpackedIndex& ix,
                                             const int* __restrict__ C,
                                             const int* __restrict__ pat,
                                             int m, int rs, int g,
                                             uint32_t gmask, int& sp,
                                             int& ep) {
  sp = 0;
  ep = ix.n;
  int cn = m > 0 ? __ldg(pat + m - 1) : PAD;
  for (int q = m - 1; q >= 0; --q) {
    const int c = cn;
    if (q > 0) cn = __ldg(pat + q - 1);
    const bool in_alphabet = c >= 1 && c < ix.sigma;
    const bool valid = in_alphabet && ep > sp;
    const int b0 = min(block_of(sp, ix.r, rs), ix.n_blocks - 1);
    const int b1 = min(block_of(ep, ix.r, rs), ix.n_blocks - 1);
    const int base0 = valid ? __ldg(ix.occ + (size_t)b0 * ix.sigma + c) : 0;
    const int base1 = valid ? __ldg(ix.occ + (size_t)b1 * ix.sigma + c) : 0;
    const int cc = valid ? __ldg(C + c) : 0;
    int n0, n1;
    group_count2<VEC>(ix.bwt + (size_t)b0 * ix.r, valid ? sp - b0 * ix.r : 0,
                      ix.bwt + (size_t)b1 * ix.r, valid ? ep - b1 * ix.r : 0,
                      c, ix.r, g, gmask, n0, n1);
    if (valid) {
      sp = cc + base0 + n0;
      ep = cc + base1 + n1;
    } else if (c != PAD && !in_alphabet) {
      ep = sp;                      // unknown symbol: empty interval
    }
  }
}

// The text position of row `row` (< n), walked by this lane's group to its
// nearest sampled row: a step loads the row's mark word and rank and the
// block's chunks up to the row's own symbol c together, then (unless the
// row is marked) C[c] and the checkpoint of c.  Where one step of chunks
// covers the block (r <= 8G) c comes from the lane that loaded it
// (__shfl_sync within the group); a longer block loads it on its own.
template <bool VEC>
__device__ __forceinline__ int group_walk(const UnpackedIndex& ix,
                                          const int* __restrict__ C,
                                          const SaSample& sa, int row,
                                          int rs, int g, uint32_t gmask) {
  int pos = 0;                      // no sample within the stride: 0
  for (int steps = 0; steps < sa.rate; ++steps) {
    const int blk = block_of(row, ix.r, rs), cut = row - blk * ix.r;
    const int* bp = ix.bwt + (size_t)blk * ix.r;
    const uint32_t mw = __ldg(sa.marks + (row >> 5));
    const int mr = __ldg(sa.mark_ranks + (row >> 5));
    int c, cnt;
    if (ix.r <= 8 * G) {
      const int ja = 4 * g, jb = 4 * (G + g);
      const int4 xa = load_chunk<VEC>(bp, ja, cut + 1);
      const int4 xb = load_chunk<VEC>(bp, jb, cut + 1);
      const int ci = cut >> 2, e = cut & 3;       // c's chunk and slot
      const int4 x = ci < G ? xa : xb;
      const int mine = e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
      c = __shfl_sync(gmask, mine, ci & (G - 1), G);
      cnt = group_sum(chunk_count(xa, ja, c, cut) +
                      chunk_count(xb, jb, c, cut), gmask);
    } else {
      c = __ldg(bp + cut);
      cnt = group_count<VEC>(bp, c, cut, gmask, g);
    }
    if ((mw >> (row & 31)) & 1u) {
      pos = sa_value(sa, mw, mr, row & 31) + steps;
      break;
    }
    row = __ldg(C + c) + __ldg(ix.occ + (size_t)blk * ix.sigma + c) + cnt;
  }
  return pos;
}

// One launch of B patterns: units of max(k, 1) a pattern in tiles of
// PER, the grid striding over the tiles.  k = 0 searches only.  The
// launch bounds name one block an SM: ptxas then keeps more of a step's
// loads in flight in registers (55-96 a thread, against 40 without the
// minimum; on the H100 the count at m = 8 read 0.0057 against 0.0082 ms
// in chip_smoke's phase 16), and the kernel still holds a batch of 1024
// at k = 16 in one wave (8 blocks an SM at 64 registers).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    fm_query_unpacked_kernel(UnpackedIndex ix, const int* __restrict__ C,
                             SaSample sa, const int* __restrict__ patterns,
                             int B, int m, int k, int* __restrict__ sp_out,
                             int* __restrict__ ep_out,
                             int* __restrict__ pos_out) {
  __shared__ int tile[2 * PER];     // the tile's (sp, ep) by pattern
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const uint32_t gmask = ((1u << G) - 1u) << (lane & (32 - G));
  const int slot = threadIdx.x / G;
  const int per = max(k, 1);
  const int rs = (ix.r & (ix.r - 1)) == 0 ? __ffs(ix.r) - 1 : -1;
  const long long units = (long long)B * per;
  // the loop is the same for every thread of a block (its barriers)
  for (long long u0 = (long long)blockIdx.x * PER; u0 < units;
       u0 += (long long)gridDim.x * PER) {
    const long long u = u0 + slot;
    const bool live = u < units;    // the last tile's spare groups idle
    const int b = live ? (int)(u / per) : B - 1;
    const int first = (int)(u0 / per);
    const int npat = (int)((min(u0 + PER, units) - 1) / per) - first + 1;
    // one (sp, ep) for the search and the walk: with a pair of its own
    // for each, the walk's launches took longer on the H100
    int sp = 0, ep = 0;
    if (slot < npat) {
      const int pb = first + slot;
      group_search<VEC>(ix, C, patterns + (size_t)pb * m, m, rs, g, gmask,
                        sp, ep);
      if (g == 0) {
        tile[2 * slot] = sp;
        tile[2 * slot + 1] = ep;
        if ((long long)pb * per >= u0) {     // the pattern's first unit
          sp_out[pb] = sp;
          ep_out[pb] = ep;
        }
      }
    }
    __syncthreads();
    if (live) {
      sp = tile[2 * (b - first)];
      ep = tile[2 * (b - first) + 1];
    }
    __syncthreads();                // read before the next tile writes
    if (k > 0 && live) {
      const int j = (int)(u - (long long)b * per);
      const int row = sp + j;
      const int p = row < ep ? group_walk<VEC>(ix, C, sa, row, rs, g, gmask)
                             : ix.n;
      if (g == 0) pos_out[(size_t)b * k + j] = p;
    }
  }
}

static const void* kernel_for(int vec) {
  return vec ? (const void*)fm_query_unpacked_kernel<true>
             : (const void*)fm_query_unpacked_kernel<false>;
}

// B patterns over `grid` blocks of THREADS (fm_query.unpacked_plan); vec
// = 1 takes 16-byte loads and needs a 16-byte aligned BWT and r % 4 == 0;
// r must be below 2^16 (a search step sums both ends' counts in one
// 32-bit word; refused otherwise).
extern "C" int fm_query_unpacked_launch(
    const void* bwt, const void* occ, int n_blocks, int sigma, int r, int n,
    const void* C, const void* marks, const void* mark_ranks,
    const void* vals, int n_vals, int sa_rate, int val_bits,
    const void* patterns, int B, int m, int k, int vec, int grid, void* sp,
    void* ep, void* pos, void* stream) {
  if (grid < 1 || r < 1 || r >= 65536 ||
      (vec && (((uintptr_t)bwt & 15) != 0 || r % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    UnpackedIndex ix{(const int*)bwt, (const int*)occ, sigma, n_blocks, r, n};
    SaSample sa{(const uint32_t*)marks, (const int*)mark_ranks,
                (const uint32_t*)vals, n_vals, sa_rate, val_bits, 0};
    void* args[] = {(void*)&ix, (void*)&C, (void*)&sa, (void*)&patterns,
                    (void*)&B, (void*)&m, (void*)&k, (void*)&sp,
                    (void*)&ep, (void*)&pos};
    const cudaError_t err =
        cudaLaunchKernel(kernel_for(vec), dim3(grid), dim3(THREADS), args, 0,
                         (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Registers, local (spilled) bytes and resident blocks of THREADS per SM of
// the kernel of load width `vec`: out = {blocks_per_sm, registers,
// threads, local bytes}.
extern "C" int fm_query_unpacked_occupancy(int vec, int* out) {
  const void* fn = kernel_for(vec);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = THREADS;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
