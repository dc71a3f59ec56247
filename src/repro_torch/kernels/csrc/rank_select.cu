// Unpacked in-block rank: count of c among the first `cut` int32 symbols of
// block `blk` (sigma > 16: proteins, bytes).  The caller adds the Occ
// checkpoint (src/repro_torch/core/fm_index.py occ_batch).
//
// Replaces: rank_select_pallas / _kernel,
//           src/repro/kernels/rank_select.py:170-201.
// Plain version: rank_select_plain in src/repro_torch/kernels/rank_select.py.
//
// Bound on the H100: bytes at large batches, latency at small ones.  A
// query reads the int32 symbols of its block below its cut (at most r: 256
// bytes at r = 64, in 32-byte sectors) plus 12 bytes of arguments and a
// 4-byte result; each query is two dependent round trips (its arguments,
// then its row), so a launch of a few thousand queries waits on one load's
// latency over the operand plus the launch itself.
//
// Design: the TPU kernel ran one query per grid step over a block fetched
// by scalar prefetch.  Here a group of G lanes answers one query (G a power
// of two from 4 to 32, planned on the host by rank_select_plan: at r = 64,
// 8 for a batch that one resident wave holds, 4 beyond, so a warp holds
// 32 / G queries).  Lane g of a group loads the 16-byte chunks g and G + g
// of each 8G-symbol step of the row, both issued before either is used
// (int4 __ldg where the row base is 16-byte aligned and r % 4 == 0; the
// same chunks symbol by symbol otherwise); a chunk is read only where its
// first symbol lies below the cut.  Each lane counts its symbols equal to
// c and below the cut, and the group sums the counts with __shfl_xor_sync
// over the group's mask in log2 G steps (a __reduce_add_sync over a partial
// mask serialises the groups of a warp: scripts/rank_select_stamps.cu).
// The grid is at most one resident wave of the card (rank_select_occupancy,
// asked once per card); groups stride over the queries beyond it, loading
// the next query's arguments while the current row is in flight.  The
// fused query kernels keep rank_common.cuh's group_counts.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 256;  // threads a block: 8 warps

// Symbols of the chunk x (symbols j .. j + 3 of the row) equal to c and
// below the cut k.
__device__ __forceinline__ int chunk_count(int4 x, int j, int c, int k) {
  return (j < k && x.x == c) + (j + 1 < k && x.y == c) +
         (j + 2 < k && x.z == c) + (j + 3 < k && x.w == c);
}

// Chunk j .. j + 3 of row, only where j lies below the cut k: one 16-byte
// load (VEC: row 16-byte aligned, j % 4 == 0, j + 3 < r), or the symbols
// below k one by one.
template <bool VEC>
__device__ __forceinline__ int4 load_chunk(const int* __restrict__ row,
                                           int j, int k) {
  int4 x = make_int4(0, 0, 0, 0);
  if (VEC) {
    if (j < k) x = __ldg(reinterpret_cast<const int4*>(row + j));
  } else {
    if (j < k) x.x = __ldg(row + j);
    if (j + 1 < k) x.y = __ldg(row + j + 1);
    if (j + 2 < k) x.z = __ldg(row + j + 2);
    if (j + 3 < k) x.w = __ldg(row + j + 3);
  }
  return x;
}

template <int G, bool VEC>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
    rank_select_kernel(const int* __restrict__ blocks, int r,
                       const int* __restrict__ blk,
                       const int* __restrict__ sym,
                       const int* __restrict__ cut, int* __restrict__ out,
                       int B) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const uint32_t gmask =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & (32 - G));
  // unsigned: q + stride stays below 2^32 for every int B
  const unsigned n = (unsigned)B, stride = gridDim.x * (THREADS / G);
  unsigned q = (blockIdx.x * THREADS + threadIdx.x) / G;
  // every lane of a group holds the same query, so the group runs its
  // loops together and its shuffles name only its own lanes
  int b = 0, c = 0, k = 0;
  if (q < n) {
    b = __ldg(blk + q);
    c = __ldg(sym + q);
    k = __ldg(cut + q);
  }
  for (; q < n; q += stride) {
    const int* row = blocks + (size_t)b * (size_t)r;
    const int cq = c, kq = min(k, r);
    if (q + stride < n) {
      b = __ldg(blk + q + stride);
      c = __ldg(sym + q + stride);
      k = __ldg(cut + q + stride);
    }
    int cnt = 0;
    for (int j0 = 0; j0 < kq; j0 += 8 * G) {
      const int ja = j0 + 4 * g, jb = j0 + 4 * (G + g);
      const int4 xa = load_chunk<VEC>(row, ja, kq);
      const int4 xb = load_chunk<VEC>(row, jb, kq);
      cnt += chunk_count(xa, ja, cq, kq) + chunk_count(xb, jb, cq, kq);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      cnt += __shfl_xor_sync(gmask, cnt, o);
    if (g == 0) out[q] = cnt;
  }
}

template <int G>
static const void* kernel_of(int vec) {
  return vec ? (const void*)rank_select_kernel<G, true>
             : (const void*)rank_select_kernel<G, false>;
}

// The kernel of group size `group` (4, 8, 16 or 32) and load width, or
// null for any other group.
static const void* kernel_for(int group, int vec) {
  switch (group) {
    case 4: return kernel_of<4>(vec);
    case 8: return kernel_of<8>(vec);
    case 16: return kernel_of<16>(vec);
    case 32: return kernel_of<32>(vec);
    default: return nullptr;
  }
}

// B queries by groups of `group` lanes over `grid` blocks of THREADS
// (rank_select_plan); vec = 1 takes 16-byte loads and needs a 16-byte
// aligned base and r % 4 == 0 (refused otherwise).
extern "C" int rank_select_launch(const void* blocks, int r, const void* blk,
                                  const void* sym, const void* cut, void* out,
                                  int B, int group, int vec, int grid,
                                  void* stream) {
  const void* fn = kernel_for(group, vec);
  if (!fn || grid < 1 ||
      (vec && (((uintptr_t)blocks & 15) != 0 || r % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    void* args[] = {(void*)&blocks, (void*)&r, (void*)&blk, (void*)&sym,
                    (void*)&cut, (void*)&out, (void*)&B};
    const cudaError_t err = cudaLaunchKernel(fn, dim3(grid), dim3(THREADS),
                                             args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Registers, local (spilled) bytes and resident blocks of THREADS per SM of
// the kernel of `group` lanes a query and load width `vec`: out =
// {blocks_per_sm, registers, threads, local bytes}.
extern "C" int rank_select_occupancy(int group, int vec, int* out) {
  const void* fn = kernel_for(group, vec);
  if (!fn) return (int)cudaErrorInvalidValue;
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
