// The paper's Re-rank step on lexicographically sorted rank pairs:
// ranks[i] = the largest j <= i where pair j differs from pair j-1 (j = 0
// always counts), i.e. the position of the head of i's equal group, and
// num_groups = the number of such heads.
//
// Replaces: rerank_scan_pallas / _kernel,
//           src/repro/kernels/rerank_scan.py:24-73 (wrapper ops.py:56-73).
// Plain version: rerank_scan_plain in src/repro_torch/kernels/rerank_scan.py.
//
// Bound on the H100: bytes.  Two int32 reads and one int32 write per pair,
// 12n bytes (about 0.96 ms at n = 2^28 and 3.35 TB/s); 8n when r2 is r1
// (the fast rounds' and the one-word q-gram init's re-rank by r1 alone),
// which reads one array.
//
// What the TPU kernel carried: its grid ran in order, so one SMEM scratch
// carried (previous pair, running head, group count) from each block to
// the next.  Blocks on the card run in no order, so the carry needs either
// more passes over the data (tile aggregates, then a fix-up) or a
// look-back inside one pass.  This is one pass with a decoupled look-back,
// one launch after one memset of the scratch:
//   - each block takes its tile of 4096 pairs from an atomic counter, so a
//     tile it looks back at belongs to a block that is already running;
//   - each warp loads its 512 contiguous pairs as four 16-byte rows per
//     lane, gets pair i-1 from the neighbouring lane by a shuffle (lane 0
//     from the previous row, or one load before the warp's span), computes
//     the flags without branches and takes the prefix max of the head
//     positions in registers, then across lanes by shuffles, then across
//     the block's eight warp maxima; ranks leave as 16-byte stores, one
//     write per slot;
//   - head positions increase along the array, so a tile with a head knows
//     its inclusive prefix max at once: its own last head.  It publishes it
//     before anything else; a tile without a head publishes "aggregate";
//   - only the slots before a tile's first head need the carry (the last
//     head before the tile), and the carry comes from the data first:
//     warp 0 also loads the 128 pairs before the tile, so a group that
//     starts there needs no look-back.  Equal pairs must be adjacent (any
//     sorted order gives that), so a group that starts farther back is
//     found by 32 probes at exponential distances: a probe equal to the
//     tile's first pair means no head between them.  The look-back over
//     the tiles' status words, 128 a round, starts at the farthest equal
//     probe: it never waits on the tiles just before, which are still
//     loading, and long runs of headless tiles (all-equal input, the seed
//     builder's first rounds) cost one probe and about one round;
//   - the group count is one atomic add per tile: a count carried through
//     the look-back would need every predecessor's prefix sum, which is the
//     full-length look-back that publishing heads at once avoids.
// A status word is 64 bits (state high, value low), written and read whole
// with relaxed strong (.gpu) accesses: the value travels in the word that
// carries its state, so no other memory needs ordering.  Misaligned inputs
// (a 4-byte aligned slice) take scalar loads in the same kernel, and the
// tail tile is guarded element by element: no padding, so no padding group
// to subtract (the JAX wrapper's INT32_MAX pad pairs merge with a real
// INT32_MAX tail pair and undercount it by one).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;                   // 16-byte rows per lane
constexpr int ROW = 32 * 4;               // pairs in one row of a warp
constexpr int WARP_SPAN = ROWS * ROW;     // 512 contiguous pairs per warp
constexpr int TILE = WARPS * WARP_SPAN;   // 4096 pairs per tile
constexpr int HEAD_INTS = 4;              // tile counter, num_groups, pad
constexpr int LOOK = 4;                   // status words per lane a round
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned AGGREGATE = 1, INCLUSIVE = 2;   // state 0: not yet

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned state, int value) {
  const unsigned long long v =
      (unsigned long long)state << 32 | (unsigned)value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// four pairs' words at i..i+3: one 16-byte load, or scalar loads guarded
// against n (the tail tile, or a start that is not 16-byte aligned)
template <bool VEC>
__device__ __forceinline__ int4 load_row(const int* __restrict__ p,
                                         long long i, int n, bool full) {
  if (VEC && full) return *reinterpret_cast<const int4*>(p + i);
  int4 v;
  v.x = i < n ? p[i] : 0;
  v.y = i + 1 < n ? p[i + 1] : 0;
  v.z = i + 2 < n ? p[i + 2] : 0;
  v.w = i + 3 < n ? p[i + 3] : 0;
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store_row(int* __restrict__ p, long long i,
                                          int n, bool full, int4 v) {
  if (VEC && full) {
    *reinterpret_cast<int4*>(p + i) = v;
    return;
  }
  if (i < n) p[i] = v.x;
  if (i + 1 < n) p[i + 1] = v.y;
  if (i + 2 < n) p[i + 2] = v.z;
  if (i + 3 < n) p[i + 3] = v.w;
}

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    v = lane >= d ? max(v, o) : v;
  }
  return v;
}

// The flags of one row (four pairs a lane at i..i+3, q1/q2 the pair before
// them) as running head positions within the lane: h.x..h.w is the last
// head at or before each pair, -1 before the lane's first; adds the heads
// to ``cnt``.  Pairs at or past n are never heads.
__device__ __forceinline__ int4 row_heads(int4 x, int4 y, int q1, int q2,
                                          long long i, int n, int& cnt) {
  const bool f0 = (i == 0) | (((x.x != q1) | (y.x != q2)) & (i < n));
  const bool f1 = ((x.y != x.x) | (y.y != y.x)) & (i + 1 < n);
  const bool f2 = ((x.z != x.y) | (y.z != y.y)) & (i + 2 < n);
  const bool f3 = ((x.w != x.z) | (y.w != y.z)) & (i + 3 < n);
  cnt += (int)f0 + (int)f1 + (int)f2 + (int)f3;
  int4 h;
  h.x = f0 ? (int)i : -1;
  h.y = f1 ? (int)(i + 1) : h.x;
  h.z = f2 ? (int)(i + 2) : h.y;
  h.w = f3 ? (int)(i + 3) : h.z;
  return h;
}

// The inclusive prefix max of the nearest tile at or before ``top`` that is
// not known to be headless (one warp; every lane returns it).  Lane l reads
// the status of tile top - l - 32q for q < LOOK; a round that sees only
// aggregates moves 128 tiles back, one that meets a tile not yet published
// reads again from that tile.
__device__ int look_back(const unsigned long long* status, int top,
                         int lane) {
  while (true) {
    unsigned long long w[LOOK];
#pragma unroll
    for (int q = 0; q < LOOK; ++q) {
      const int t = top - lane - 32 * q;
      w[q] = t >= 0 ? load_status(status + t)
                    : (unsigned long long)INCLUSIVE << 32 | FULL;  // -1
    }
    int step = 32 * LOOK;
#pragma unroll
    for (int q = 0; q < LOOK; ++q) {
      const unsigned other =
          __ballot_sync(FULL, (unsigned)(w[q] >> 32) != AGGREGATE);
      if (other) {
        const int src = __ffs(other) - 1;
        const unsigned long long hit = __shfl_sync(FULL, w[q], src);
        if ((unsigned)(hit >> 32) == INCLUSIVE) return (int)(unsigned)hit;
        step = 32 * q + src;
        break;
      }
    }
    top -= step;
  }
}

template <bool ALIAS, bool VEC>
__global__ void __launch_bounds__(THREADS)
    rerank_kernel(const int* __restrict__ r1, const int* __restrict__ r2,
                  int n, int* __restrict__ ranks, int* __restrict__ head) {
  __shared__ int s_tile, s_behind, s_carry;
  __shared__ bool s_lead;
  __shared__ int w_max[WARPS], w_cnt[WARPS];
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(head + HEAD_INTS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(head, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long tile0 = (long long)tile * TILE;
  const bool full = tile0 + TILE <= n;
  const long long seg = tile0 + warp * WARP_SPAN;

  int4 a[ROWS], b[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long i = seg + k * ROW + lane * 4;
    a[k] = load_row<VEC>(r1, i, n, full);
    if (!ALIAS) b[k] = load_row<VEC>(r2, i, n, full);
  }
  // the pair before the warp's span (every lane reads the same word)
  const long long before = seg == 0 ? 0 : min(seg - 1, (long long)n - 1);
  int prev1 = r1[before], prev2 = ALIAS ? prev1 : r2[before];
  // warp 0 of a tile after the first: the row of pairs before the tile and
  // the pair before that row (tile0 >= TILE > ROW, and all lie below n)
  const bool behind_row = warp == 0 && tile > 0;
  int4 ba = make_int4(0, 0, 0, 0), bb = ba;
  int bp1 = 0, bp2 = 0;
  if (behind_row) {
    ba = load_row<VEC>(r1, tile0 - ROW + lane * 4, n, true);
    if (!ALIAS) bb = load_row<VEC>(r2, tile0 - ROW + lane * 4, n, true);
    bp1 = r1[tile0 - ROW - 1];
    bp2 = ALIAS ? bp1 : r2[tile0 - ROW - 1];
  }

  int v[ROWS * 4];
  int run = -1, cnt = 0;
  bool lead = false;   // thread 0: the tile's first pair is a head
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int4 x = a[k];
    const int4 y = ALIAS ? a[k] : b[k];
    // lane l-1's last pair; lane 0 takes the previous row's lane 31
    const int t1 = __shfl_sync(FULL, x.w, (lane + 31) & 31);
    const int t2 = ALIAS ? t1 : __shfl_sync(FULL, y.w, (lane + 31) & 31);
    const int q1 = lane ? t1 : prev1, q2 = lane ? t2 : prev2;
    prev1 = t1;
    prev2 = t2;
    const int4 h = row_heads(x, y, q1, q2, seg + k * ROW + lane * 4, n, cnt);
    if (k == 0) lead = h.x >= 0;
    const int incl = warp_incl_max(h.w, lane);
    int excl = __shfl_up_sync(FULL, incl, 1);
    excl = max(lane ? excl : -1, run);
    v[4 * k] = max(h.x, excl);
    v[4 * k + 1] = max(h.y, excl);
    v[4 * k + 2] = max(h.z, excl);
    v[4 * k + 3] = max(h.w, excl);
    run = max(run, __shfl_sync(FULL, incl, 31));
  }
  cnt = (int)__reduce_add_sync(FULL, (unsigned)cnt);
  int behind = -1;   // the last head among the ROW pairs before the tile
  if (behind_row) {
    const int4 y = ALIAS ? ba : bb;
    const int t1 = __shfl_sync(FULL, ba.w, (lane + 31) & 31);
    const int t2 = ALIAS ? t1 : __shfl_sync(FULL, y.w, (lane + 31) & 31);
    int unused = 0;
    const int4 h = row_heads(ba, y, lane ? t1 : bp1, lane ? t2 : bp2,
                             tile0 - ROW + lane * 4, n, unused);
    behind = __reduce_max_sync(FULL, h.w);
  }
  if (lane == 0) {
    w_max[warp] = run;
    w_cnt[warp] = cnt;
  }
  if (threadIdx.x == 0) {
    s_lead = lead;
    s_behind = behind;
  }
  __syncthreads();

  int tile_max = -1;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) tile_max = max(tile_max, w_max[k]);
  if (threadIdx.x == 0) {
    int tile_cnt = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) tile_cnt += w_cnt[k];
    if (tile_cnt) atomicAdd(head + 1, tile_cnt);
    store_status(status + tile, tile_max >= 0 ? INCLUSIVE : AGGREGATE,
                 tile_max);
  }
  // the carry: none if the tile's first pair is a head, else the last head
  // in the row before the tile, else from the probes and the look-back
  int carry = -1;
  if (!s_lead) {
    if (s_behind >= 0) {
      carry = s_behind;
    } else {
      if (warp == 0) {
        // pairs tile0 - ROW - 1 .. tile0 are all equal; lane l probes
        // (2^l - 1) rows farther back, and the equal probes are a prefix
        // of the lanes (sorted pairs), lane 0 always among them
        const long long p =
            tile0 - ROW - 1 - (((long long)1 << lane) - 1) * ROW;
        const bool eq =
            p >= 0 && r1[p] == bp1 && (ALIAS || r2[p] == bp2);
        const unsigned m = __ballot_sync(FULL, eq);
        const int last = (m == FULL ? 32 : __ffs(~m) - 1) - 1;
        const long long far =
            tile0 - ROW - 1 - (((long long)1 << last) - 1) * ROW;
        const int c =
            look_back(status, min(tile - 1, (int)(far / TILE)), lane);
        if (lane == 0) s_carry = c;
      }
      __syncthreads();
      carry = s_carry;
    }
    if (tile_max < 0 && threadIdx.x == 0)
      store_status(status + tile, INCLUSIVE, carry);
  }

  // the carry into this warp's span: the tile's and the warps before it
  int c = carry;
  for (int w = 0; w < warp; ++w) c = max(c, w_max[w]);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int4 o = make_int4(max(v[4 * k], c), max(v[4 * k + 1], c),
                             max(v[4 * k + 2], c), max(v[4 * k + 3], c));
    store_row<VEC>(ranks, seg + k * ROW + lane * 4, n, full, o);
  }
}

}  // namespace

// scratch: int32[4 + 2 * ceil(n / 4096)], 16-byte aligned: [0] the tile
// counter, [1] num_groups, [2..3] unused, then one 64-bit status per tile.
// The entry zeroes it (one cudaMemsetAsync) and launches one kernel.
extern "C" int rerank_scan_launch(const void* r1, const void* r2, int n,
                                  void* ranks, void* scratch,
                                  int scratch_ints, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nt = (int)(((long long)n + TILE - 1) / TILE);
  if (scratch_ints < HEAD_INTS + 2 * nt || (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * (size_t)(HEAD_INTS + 2 * nt), s);
  if (err != cudaSuccess) return (int)err;
  const bool alias = r1 == r2;
  const bool vec =
      ((uintptr_t)r1 | (uintptr_t)r2 | (uintptr_t)ranks) % 16 == 0;
  const int* a = (const int*)r1;
  const int* b = (const int*)r2;
  int* out = (int*)ranks;
  int* head = (int*)scratch;
  if (alias && vec)
    rerank_kernel<true, true><<<nt, THREADS, 0, s>>>(a, b, n, out, head);
  else if (alias)
    rerank_kernel<true, false><<<nt, THREADS, 0, s>>>(a, b, n, out, head);
  else if (vec)
    rerank_kernel<false, true><<<nt, THREADS, 0, s>>>(a, b, n, out, head);
  else
    rerank_kernel<false, false><<<nt, THREADS, 0, s>>>(a, b, n, out, head);
  return (int)cudaGetLastError();
}
