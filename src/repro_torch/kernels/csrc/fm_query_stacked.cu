// Fused FM queries over a stacked segment catalog: every pattern of a
// (B, m) batch against every real segment of the bucket, the backward
// search and, for locate (k > 0), the LF-walk of each candidate row to its
// SA sample, in one launch per served batch.  Two entry points:
// fm_query_stacked_packed (fused 2- or 4-bit rows; DNA) and
// fm_query_stacked_unpacked (int32 blocks plus per-block checkpoints;
// proteins, bytes).
//
// Replaces: rank_packed_pallas / _packed_kernel and rank_select_pallas /
//           _kernel (src/repro/kernels/rank_select.py:133 and :179), as
//           the JAX package drives them from count_stacked /
//           locate_stacked (src/repro/core/fm_index.py:838-925): a
//           lax.scan of m search steps and a fori_loop of sa_sample_rate
//           walk steps, each two (search) or one (walk) batched rank
//           dispatches over the flat segment x batch lanes.
// Plain versions: fm_query_stacked_packed_plain / _unpacked_plain in
//           src/repro_torch/kernels/fm_query.py (the same step loops over
//           rank_packed_plain / rank_select_plain on the flat lanes).
//
// Bucket layout (core/fm_index.py StackedFMIndex): segment s owns block
// rows [s*NB, s*NB + n_blocks[s]) of fused / blocks, checkpoint rows
// [s*NB, ...) of occ (int32[S, NB, sigma] read flat), C row s, mark words
// [s*MW, (s+1)*MW) and raw (decoded) SA values [s*MV, (s+1)*MV).  Every
// per-segment base is a 64-bit offset: seg_pad x NB x r passes 2^31 at
// catalog scale.  Segments s >= n_seg are pad segments: their rows are
// written as an empty interval with every position 0.
//
// Bound on the H100: the chain of dependent loads, and the work each
// segment's lanes issue along it.  A pair (segment, pattern) takes m
// search steps, then each of its first k rows up to sa_sample_rate walk
// steps, each step a random round trip into one segment's rows (60-byte
// rows on a 60-byte stride for DNA at r = 64).  The bytes are a few MB a
// batch: chip_smoke.py reports that bound and, beside it, the latency
// floor (dependent loads x one load's latency from
// scripts/pointer_chase.cu over the bucket's words), which a chain of 64
// steps cannot beat.  Measured on the card, the design this one replaced
// (a thread per segment, pattern and slot, every lane of a pattern
// repeating its search) grew in proportion to the segments inside one
// resident wave as much as across waves: the repeated searches' issued
// loads and counting were its cost, not the waves.  The work is random
// gathers of a few sectors each, so wgmma and TMA do not apply; what the
// card offers is many chains in flight at once.
//
// Design: each (segment, pattern) pair is searched once, and a slot at or
// past its interval's end is written the segment's length without a walk.
// A block takes one tile of consecutive pairs of one segment and stages
// the segment's C row in shared memory; blocks of pad segments write their
// rows and return before that, so every search runs in converged warps.
// Packed: a lane a pair, as few pairs a block as still make the launch
// one resident wave at this kernel's register count (the wrapper's plan,
// from fm_query_stacked_occupancy: the searches spread over the most SMs,
// the most threads for the walks).  A pair has min(ep - sp, k) live rows:
// a prefix over the tile's pairs in shared memory lays them out as the
// tile's walk list, and every thread of the block walks items of it, one
// walk a thread at a time, thread x first item x and then the next from a
// shared counter, so no warp waits on another's longest walk.  (Two or
// four walks a thread, their loads issued together, took more registers
// than they won back on the card, and spilled.)  Unpacked: a group of 16
// lanes a pair (unpacked_search's ballot read), 8 pairs a block; lane j
// of the group walks the pair's slots j, j + 16, ... below k (a walk list
// over the block, as on the packed layout, measured slower on the card).
// Both kernels are held to 48 registers, 10 blocks of 128 an SM, as the
// replaced design ran.  The lane bodies (packed_search, unpacked_search,
// packed_walk, unpacked_walk) are those of the single-index kernels
// (fm_query_common.cuh), so a segment's answers are those of its own
// index bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_query_common.cuh"

constexpr int THREADS = 128;     // threads a block
// Resident blocks an SM holds of either kernel: 10 of 128 threads is 48
// registers a thread, what the lane bodies take without spilling (left
// free, the compiler takes twice as many for the unpacked kernel, which
// then ran slower).
constexpr int MIN_BLOCKS = 10;

// What every segment shares: its bucket strides and per-segment vectors.
struct Stack {
  int n_seg;                 // real segments
  int seg_pad;               // segments of the bucket (real + pad)
  int NB;                    // blocks per segment (the bucket's)
  const int* n_blocks;       // [S] true block counts
  const int* lengths;        // [S] true text lengths
  const int* C;              // [S, sigma]
  const uint32_t* marks;     // [S * MW]
  const int* mark_ranks;     // [S * MW]
  const uint32_t* vals;      // [S * MV] raw values
  long long MW, MV;
  int sa_rate;
};

// The SA sample of segment `seg`: its mark words, and its slice of the
// value stream through the offset (the clamp spans the whole stream).
__device__ __forceinline__ SaSample segment_sample(const Stack& st, int seg) {
  return SaSample{st.marks + seg * st.MW, st.mark_ranks + seg * st.MW,
                  st.vals, (long long)st.seg_pad * st.MV, st.sa_rate, 0,
                  seg * st.MV};
}

// Block b takes tile b: pairs [b0, b0 + np) of segment seg, np <= tile.
struct TileOf {
  int seg, b0, np;
  size_t row0;            // the output row of its first pair
  __device__ TileOf(int B, int tile) {
    const int per_seg = (B + tile - 1) / tile;
    seg = blockIdx.x / per_seg;
    b0 = (blockIdx.x - seg * per_seg) * tile;
    np = min(tile, B - b0);
    row0 = (size_t)seg * B + b0;
  }
};

// A tile of a pad segment (seg >= n_seg): an empty interval and every
// position 0 for each of its pairs.
__device__ __forceinline__ void pad_tile(const TileOf& ti, int k,
                                         int* __restrict__ sp_out,
                                         int* __restrict__ ep_out,
                                         int* __restrict__ pos_out) {
  for (int i = threadIdx.x; i < ti.np; i += blockDim.x) {
    sp_out[ti.row0 + i] = 0;
    ep_out[ti.row0 + i] = 0;
  }
  for (int i = threadIdx.x; i < ti.np * k; i += blockDim.x)
    pos_out[ti.row0 * k + i] = 0;
}

// A packed tile's shared state: its pairs' sp, the exclusive prefix of
// their live rows (off[p] .. off[p + 1] are pair p's walk items), the
// warps' sums of that prefix, and the next walk item not yet taken.
struct Tile {
  int sp[THREADS];
  int off[THREADS + 1];
  int warp_sum[THREADS / 32];
  int next;
};

// off[i] = sum of v over threads below i, off[blockDim] = the total (every
// thread of the block calls it with its own v).
__device__ __forceinline__ void tile_offsets(Tile& t, int v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) t.warp_sum[warp] = x;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += t.warp_sum[w];
  t.off[threadIdx.x] = base + x - v;
  if (threadIdx.x == blockDim.x - 1) t.off[blockDim.x] = base + x;
  __syncthreads();
}

// The pair of walk item i (< off[np]): the last pair p < np whose first
// item is at or below i.
__device__ __forceinline__ int item_pair(const Tile& t, int np, int i) {
  int lo = 0, hi = np - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.off[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The tile's walks after its search: the walk list from the pairs' live
// rows (`live` from pair threadIdx.x, 0 from other threads), the slots past
// each pair's live rows written `fill`, then the list walked by every
// thread of the block.  Item i of pair p (off[p] <= i < off[p + 1]) is row
// sp[p] + j, j = i - off[p], written to position (row0 + p) * k + j by
// `walk` (row -> text position).  Thread x takes item x first, then, while
// items are left past the first blockDim, the next from t.next, so a tile
// with few walks spends no atomic and no warp waits on another's walk.
template <class Walk>
__device__ __forceinline__ void tile_walks(Tile& t, int live, int np,
                                           size_t row0, int k, int fill,
                                           int* __restrict__ pos_out,
                                           Walk walk) {
  if (threadIdx.x == 0) t.next = blockDim.x;
  tile_offsets(t, live);
  for (int i = threadIdx.x; i < np * k; i += blockDim.x) {
    const int p = i / k, j = i - p * k;
    if (j >= t.off[p + 1] - t.off[p]) pos_out[row0 * k + i] = fill;
  }
  const int total = t.off[np];
  for (int i = threadIdx.x; i < total;) {
    const int p = item_pair(t, np, i), j = i - t.off[p];
    pos_out[(row0 + p) * k + j] = walk(t.sp[p] + j);
    i = total > (int)blockDim.x ? atomicAdd(&t.next, 1) : total;
  }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fm_query_stacked_packed_kernel(
    const uint32_t* __restrict__ fused, int wid, int sigma, int r, Stack st,
    const int* __restrict__ patterns, int B, int m, int k, int tile,
    int* __restrict__ sp_out, int* __restrict__ ep_out,
    int* __restrict__ pos_out) {
  extern __shared__ int sC[];
  __shared__ Tile t;
  const TileOf ti(B, tile);
  if (ti.seg >= st.n_seg) {
    pad_tile(ti, k, sp_out, ep_out, pos_out);
    return;
  }
  for (int i = threadIdx.x; i < sigma; i += blockDim.x)
    sC[i] = st.C[(size_t)ti.seg * sigma + i];
  __syncthreads();
  const PackedIndex ix{fused + (size_t)ti.seg * st.NB * wid, wid, sigma,
                       wid - sigma, st.n_blocks[ti.seg], r,
                       st.lengths[ti.seg]};
  int live = 0;
  if (threadIdx.x < ti.np) {
    int sp, ep;
    packed_search<BITS>(ix, sC, patterns + (size_t)(ti.b0 + threadIdx.x) * m,
                        m, sp, ep);
    sp_out[ti.row0 + threadIdx.x] = sp;
    ep_out[ti.row0 + threadIdx.x] = ep;
    t.sp[threadIdx.x] = sp;
    live = min(ep - sp, k);
  }
  if (k == 0) return;
  const SaSample sa = segment_sample(st, ti.seg);
  tile_walks(t, live, ti.np, ti.row0, k, ix.n, pos_out, [&](int row) {
    return packed_walk<BITS>(ix, sC, sa, row);
  });
}

// Tiles of THREADS / GROUP pairs, a group of GROUP lanes each: the group
// searches its pair once, then its lane j walks the pair's slots j,
// j + GROUP, ... below k, one after another; a slot at or past ep is
// written the segment's length without a walk.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fm_query_stacked_unpacked_kernel(
    const int* __restrict__ blocks, const int* __restrict__ occ, int sigma,
    int r, Stack st, const int* __restrict__ patterns, int B, int m, int k,
    int* __restrict__ sp_out, int* __restrict__ ep_out,
    int* __restrict__ pos_out) {
  extern __shared__ int sC[];
  const TileOf ti(B, THREADS / GROUP);
  if (ti.seg >= st.n_seg) {
    pad_tile(ti, k, sp_out, ep_out, pos_out);
    return;
  }
  for (int i = threadIdx.x; i < sigma; i += blockDim.x)
    sC[i] = st.C[(size_t)ti.seg * sigma + i];
  __syncthreads();
  const size_t base = (size_t)ti.seg * st.NB;
  const UnpackedIndex ix{blocks + base * r, occ + base * sigma, sigma,
                         st.n_blocks[ti.seg], r, st.lengths[ti.seg]};
  // every lane of the block takes part in the search's votes; groups past
  // the batch search pattern B - 1 again and write nothing
  const int g = threadIdx.x / GROUP, lane = threadIdx.x % GROUP;
  int sp, ep;
  unpacked_search(ix, sC, patterns + (size_t)min(ti.b0 + g, B - 1) * m, m,
                  sp, ep);
  if (g >= ti.np) return;
  if (lane == 0) {
    sp_out[ti.row0 + g] = sp;
    ep_out[ti.row0 + g] = ep;
  }
  const SaSample sa = segment_sample(st, ti.seg);
  for (int j = lane; j < k; j += GROUP) {
    const int row = sp + j;
    pos_out[(ti.row0 + g) * k + j] =
        row < ep ? unpacked_walk(ix, sC, sa, row) : ix.n;
  }
}

// out = {resident blocks per SM, registers per thread, threads per block,
// local (spilled) bytes per thread} of the packed (unpacked = 0, bits 2 or
// 4) or unpacked entry's kernel with sigma ints of dynamic shared memory:
// the wrapper sizes its tiles to one resident wave.
extern "C" int fm_query_stacked_occupancy(int unpacked, int bits, int sigma,
                                          int* out) {
  const void* fn =
      unpacked ? (const void*)fm_query_stacked_unpacked_kernel
               : (bits == 2 ? (const void*)fm_query_stacked_packed_kernel<2>
                            : (const void*)fm_query_stacked_packed_kernel<4>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, THREADS, (size_t)sigma * sizeof(int));
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = THREADS;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" int fm_query_stacked_packed_launch(
    const void* fused, int wid, int NB, int sigma, int bits, int r,
    int n_seg, int seg_pad, const void* n_blocks, const void* lengths,
    const void* C, const void* marks, const void* mark_ranks,
    const void* vals, long long MW, long long MV, int sa_rate,
    const void* patterns, int B, int m, int k, int tile, void* sp, void* ep,
    void* pos, void* stream) {
  if (B <= 0 || seg_pad <= 0) return (int)cudaGetLastError();
  if (tile < 1 || tile > THREADS) return (int)cudaErrorInvalidValue;
  const Stack st{n_seg, seg_pad, NB, (const int*)n_blocks,
                 (const int*)lengths, (const int*)C, (const uint32_t*)marks,
                 (const int*)mark_ranks, (const uint32_t*)vals, MW, MV,
                 sa_rate};
  const int grid = seg_pad * ((B + tile - 1) / tile);   // a block a tile
  const size_t smem = (size_t)sigma * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 2)
    fm_query_stacked_packed_kernel<2><<<grid, THREADS, smem, s>>>(
        (const uint32_t*)fused, wid, sigma, r, st, (const int*)patterns, B,
        m, k, tile, (int*)sp, (int*)ep, (int*)pos);
  else
    fm_query_stacked_packed_kernel<4><<<grid, THREADS, smem, s>>>(
        (const uint32_t*)fused, wid, sigma, r, st, (const int*)patterns, B,
        m, k, tile, (int*)sp, (int*)ep, (int*)pos);
  return (int)cudaGetLastError();
}

extern "C" int fm_query_stacked_unpacked_launch(
    const void* blocks, const void* occ, int NB, int sigma, int r,
    int n_seg, int seg_pad, const void* n_blocks, const void* lengths,
    const void* C, const void* marks, const void* mark_ranks,
    const void* vals, long long MW, long long MV, int sa_rate,
    const void* patterns, int B, int m, int k, void* sp, void* ep, void* pos,
    void* stream) {
  if (B <= 0 || seg_pad <= 0) return (int)cudaGetLastError();
  const Stack st{n_seg, seg_pad, NB, (const int*)n_blocks,
                 (const int*)lengths, (const int*)C, (const uint32_t*)marks,
                 (const int*)mark_ranks, (const uint32_t*)vals, MW, MV,
                 sa_rate};
  const int tile = THREADS / GROUP;
  const int grid = seg_pad * ((B + tile - 1) / tile);   // a block a tile
  fm_query_stacked_unpacked_kernel<<<grid, THREADS,
                                     (size_t)sigma * sizeof(int),
                                     (cudaStream_t)stream>>>(
      (const int*)blocks, (const int*)occ, sigma, r, st,
      (const int*)patterns, B, m, k, (int*)sp, (int*)ep, (int*)pos);
  return (int)cudaGetLastError();
}
