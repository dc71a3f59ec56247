// The paper's Re-rank step on lexicographically sorted rank pairs:
// ranks[i] = the largest j <= i where pair j differs from pair j-1 (j = 0
// always counts), i.e. the position of the head of i's equal group, and
// num_groups = the number of such heads.
//
// Replaces: rerank_scan_pallas / _kernel,
//           src/repro/kernels/rerank_scan.py:24-73 (wrapper ops.py:56-73).
// Plain version: rerank_scan_plain in src/repro_torch/kernels/rerank_scan.py.
//
// Bound on the H100: bytes.  Two int32 reads and one int32 write per pair:
// 12n bytes, about 0.96 ms at n = 2^28 and 3.35 TB/s.
//
// Design: the TPU kernel ran its grid in order and carried (previous pair,
// running head, group count) in SMEM from one block to the next.  Blocks on
// the card run in no order, so nothing may be carried.  The flags need no
// carry at all: thread i reads pair i-1 from global memory (an L1 hit).
// Only the running head and the group count cross tiles, in three passes
// launched from one C entry:
//   1. per 2048-pair tile: the flags, the tile-local prefix max of the head
//      positions (-1 before the tile's first head) written to ranks, and the
//      tile's aggregates: its largest head, its head count, its first head;
//   2. one block turns the tile maxima into an exclusive prefix max (the
//      carry into each tile) and sums the counts into num_groups;
//   3. per tile, only the slots before its first head take the carry.
// Heads increase along the array, so a slot at or after its tile's first
// head already holds its final rank: pass 3 writes only the leading run of
// each tile, and the HBM traffic stays near the 12n bound unless groups
// span whole tiles.  No padding: a tail guard handles any n >= 1, so there
// is no padding group to subtract (the JAX wrapper's INT32_MAX pad pairs
// merge with a real INT32_MAX tail pair and undercount it by one).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // pairs per block of pass 1 and 3
constexpr int CARRY_THREADS = 1024;

// shared-memory index with one pad word per 32: thread t reading items
// t*ITEMS..t*ITEMS+7 then hits 32 distinct banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
  return v;
}

__global__ void rerank_tile_kernel(const int* __restrict__ r1,
                                   const int* __restrict__ r2, int n,
                                   int* __restrict__ ranks,
                                   int* __restrict__ tile_max,
                                   int* __restrict__ tile_cnt,
                                   int* __restrict__ tile_first) {
  __shared__ int heads[TILE + TILE / 32];
  __shared__ int w_max[THREADS / 32], w_cnt[THREADS / 32],
      w_first[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * TILE;

  int cnt = 0, first = INT_MAX;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + tid;
    const long long i = base + j;
    int h = -1;
    if (i < n && (i == 0 || r1[i] != r1[i - 1] || r2[i] != r2[i - 1])) {
      h = (int)i;
      ++cnt;
      first = min(first, h);
    }
    heads[padded(j)] = h;
  }
  __syncthreads();

  int v[ITEMS];
  int run = -1;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    run = max(run, heads[padded(tid * ITEMS + k)]);
    v[k] = run;
  }
  const int incl = warp_incl_max(run);
  cnt = warp_sum(cnt);
  first = warp_min(first);
  if (lane == 31) w_max[warp] = incl;
  if (lane == 0) {
    w_cnt[warp] = cnt;
    w_first[warp] = first;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = -1;
  for (int w = 0; w < warp; ++w) excl = max(excl, w_max[w]);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    heads[padded(tid * ITEMS + k)] = max(v[k], excl);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + tid;
    const long long i = base + j;
    if (i < n) ranks[i] = heads[padded(j)];
  }
  if (tid == 0) {
    int m = -1, c = 0, f = INT_MAX;
    for (int w = 0; w < THREADS / 32; ++w) {
      m = max(m, w_max[w]);
      c += w_cnt[w];
      f = min(f, w_first[w]);
    }
    const long long end = base + TILE < n ? base + TILE : n;
    tile_max[blockIdx.x] = m;
    tile_cnt[blockIdx.x] = c;
    tile_first[blockIdx.x] = f == INT_MAX ? (int)end : f;
  }
}

// One block: tile_max -> exclusive prefix max (the carry into each tile),
// sum of tile_cnt -> *ngroups.  Each thread owns a contiguous run of tiles.
__global__ void rerank_carry_kernel(int* __restrict__ tile_max,
                                    const int* __restrict__ tile_cnt, int nt,
                                    int* __restrict__ ngroups) {
  __shared__ int w_max[CARRY_THREADS / 32], w_cnt[CARRY_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nt + CARRY_THREADS - 1) / CARRY_THREADS;
  const int lo = min(tid * per, nt), hi = min(lo + per, nt);
  int m = -1, c = 0;
  for (int t = lo; t < hi; ++t) {
    m = max(m, tile_max[t]);
    c += tile_cnt[t];
  }
  const int incl = warp_incl_max(m);
  c = warp_sum(c);
  if (lane == 31) w_max[warp] = incl;
  if (lane == 0) w_cnt[warp] = c;
  __syncthreads();
  int excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = -1;
  for (int w = 0; w < warp; ++w) excl = max(excl, w_max[w]);
  for (int t = lo; t < hi; ++t) {
    const int x = tile_max[t];
    tile_max[t] = excl;
    excl = max(excl, x);
  }
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < CARRY_THREADS / 32; ++w) total += w_cnt[w];
    *ngroups = total;
  }
}

__global__ void rerank_fix_kernel(int* __restrict__ ranks,
                                  const int* __restrict__ carry,
                                  const int* __restrict__ tile_first) {
  const long long base = (long long)blockIdx.x * TILE;
  const int end = tile_first[blockIdx.x];
  const int c = carry[blockIdx.x];
  for (long long i = base + threadIdx.x; i < end; i += THREADS) ranks[i] = c;
}

}  // namespace

// scratch: int32[3 * ceil(n / 2048)] (tile maxima/carries, counts, firsts)
extern "C" int rerank_scan_launch(const void* r1, const void* r2, int n,
                                  void* ranks, void* ngroups, void* scratch,
                                  int scratch_ints, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nt = (n + TILE - 1) / TILE;
  if (scratch_ints < 3 * nt) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* tile_max = (int*)scratch;
  int* tile_cnt = tile_max + nt;
  int* tile_first = tile_cnt + nt;
  rerank_tile_kernel<<<nt, THREADS, 0, s>>>((const int*)r1, (const int*)r2,
                                            n, (int*)ranks, tile_max,
                                            tile_cnt, tile_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rerank_carry_kernel<<<1, CARRY_THREADS, 0, s>>>(tile_max, tile_cnt, nt,
                                                  (int*)ngroups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rerank_fix_kernel<<<nt, THREADS, 0, s>>>((int*)ranks, tile_max,
                                           tile_first);
  return (int)cudaGetLastError();
}
