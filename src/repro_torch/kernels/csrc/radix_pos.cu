// One stable 8-bit LSD radix pass: destination of every key = bin base of
// its (tile, digit) + its stable rank among the keys of its tile with the
// same digit, fused with the scatter of up to four int32 operands to that
// destination.
//
// Replaces: radix_pos_pallas / _pos_kernel,
//           src/repro/kernels/radix_sort.py:43-76, and the XLA scatter
//           that follows it on the TPU (radix_sort.py:110).
// Plain version: radix_pos_plain / radix_scatter_plain in
//           src/repro_torch/kernels/radix_sort.py.
//
// Bound on the H100: bytes.  Per pass over n keys with k operands: the
// bases are read once (1 KiB per tile: n/8 bytes at the sort engine's
// 8192-key tiles), and each operand is read and written once (8kn).  When
// the key word is one of the operands (the sort engine always passes it),
// the kernel writes the keys it ranked from registers and does not read
// that operand again: (8k + 1/8) n bytes, about 1.93 ms at n = 2^28, k = 3,
// 3.35 TB/s.  Writing the positions (4n) is only done when asked for.
//
// Design: stability is the hazard.  An atomic-increment scatter would put
// equal digits in arbitrary order and the suffix array would differ from
// the reference.  The second hazard is the write pattern: a key written
// straight from its thread lands on a random address, a short run per
// digit per tile, on a sector of its own.  One CUDA block takes one tile of
// TILE = 32 * WARPS * ITEMS keys (1024, the JAX signature's block, or
// 8192, the sort engine's) and works in two phases:
//   1. rank: each warp walks its contiguous chunk of 32 * ITEMS keys in
//      input order, 32 at a time (coalesced loads, all in flight at once);
//      eight ballots group the lanes holding the same digit, and the
//      group's lowest lane adds the group size to a per-(warp, digit)
//      counter in shared memory, so a key's rank inside its (warp, digit)
//      is the counter before the group plus its rank in the group.  An
//      exclusive scan over the warps of each digit and one over the 256
//      digits (warp shuffles) give each key its tile-local slot: the order
//      a stable local sort gives.
//   2. write, per operand: the tile's values go into a shared buffer at
//      their slots; then thread j takes slot j, so consecutive threads
//      write consecutive addresses within each digit run:
//      out[base[tile, d_j] - start[d_j] + j].  Runs are 32 keys long at
//      8192-key tiles with uniform digits (4 at 1024), longer when digits
//      are skewed, and neighbouring tiles fill the rest of each sector
//      in L2 at about the same time.
// Slots stay in registers across the operands; the key word is written
// from the registers that ranked it.  __launch_bounds__ holds a thread to
// 64 registers, so two 512-thread blocks of an 8192-key tile (57 KB of
// shared memory each) share an SM.  The bases are read through two
// strides, so a digit-major table (the layout of radix_hist.cu's output)
// and a tile-major one both work unchanged.
//
// Measured on the H100 (chip_smoke.py phase 1): the rank phase alone takes
// about 1.2 ms at n = 2^28 whatever the digits, bound by the instructions
// of eight ballots per key rather than by bytes; the writes take the rest,
// and they slow down as the runs per digit shorten.  Larger tiles give
// longer runs and fewer base rows: in a sweep of 1024 ... 8192-key tiles,
// 8192 was the fastest on the main path's keys and on uniform ones.
#include <cstdint>
#include <cuda_runtime.h>

#define MAX_OPS 4

namespace {

struct Operands {
  const int* in[MAX_OPS];
  int* out[MAX_OPS];
};

// The lanes of the warp holding the same 8-bit digit as this lane: eight
// ballots, one per digit bit, whatever the number of distinct digits
// (__match_any_sync slows down with every distinct value in the warp).
__device__ __forceinline__ unsigned match_digit(int d) {
  unsigned peers = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned vote = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Thread j writes slot j of the tile (j = tid, tid + THREADS, ...):
// consecutive threads, consecutive addresses within each digit run.
template <int THREADS, int ITEMS>
__device__ __forceinline__ void write_slots(int* __restrict__ out,
                                            const int* buf, const int* adj,
                                            const unsigned char* dig) {
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int j = threadIdx.x + r * THREADS;
    out[adj[dig[j]] + j] = buf[j];
  }
}

template <int WARPS, int ITEMS>
__global__ void __launch_bounds__(WARPS * 32, 1024 / (WARPS * 32))
    radix_pos_kernel(const uint32_t* __restrict__ keys,
                     const int* __restrict__ base, int tile_stride,
                     int digit_stride, int shift, int* __restrict__ pos_out,
                     Operands ops, int nops) {
  constexpr int THREADS = WARPS * 32;
  constexpr int TILE = THREADS * ITEMS;
  static_assert(THREADS >= 256, "one thread per digit in the scan");
  extern __shared__ int smem[];
  int* table = smem;                   // [WARPS][256] counts, then offsets
  int* buf = table + WARPS * 256;      // [TILE] one operand in slot order
  int* adj = buf + TILE;               // [256] global base - tile start
  int* wsum = adj + 256;               // [8] digit-scan warp totals
  unsigned char* dig = (unsigned char*)(wsum + 8);   // [TILE] slot digits

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t mine = (size_t)blockIdx.x * TILE + warp * 32 * ITEMS + lane;
  for (int i = tid; i < WARPS * 256; i += THREADS) table[i] = 0;
  // the tile's base row, loaded early so its latency hides behind the rank
  const int my_base = tid < 256 ? base[(size_t)blockIdx.x * tile_stride +
                                       (size_t)tid * digit_stride]
                                : 0;
  uint32_t key[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) key[i] = keys[mine + i * 32];
  __syncthreads();

  // 1. rank inside (warp, digit), in input order
  int* row = table + warp * 256;
  const unsigned below = (1u << lane) - 1u;
  int slot[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int d = (key[i] >> shift) & 0xFF;
    const unsigned peers = match_digit(d);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader) {
      before = row[d];
      row[d] = before + __popc(peers);
    }
    before = __shfl_sync(0xFFFFFFFFu, before, leader);
    slot[i] = before + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();

  // exclusive scans: over the warps of each digit, then over the digits
  int total = 0;
  if (tid < 256) {
    for (int w = 0; w < WARPS; ++w) {
      const int c = table[w * 256 + tid];
      table[w * 256 + tid] = total;
      total += c;
    }
  }
  int incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += v;
  }
  if (tid < 256 && lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (tid < 256) {
    int start = incl - total;
    for (int w = 0; w < warp; ++w) start += wsum[w];
    for (int w = 0; w < WARPS; ++w) table[w * 256 + tid] += start;
    adj[tid] = my_base - start;
  }
  __syncthreads();

  // tile-local slots; the key word, when it is an operand, goes straight
  // into the buffer from registers
  int key_op = -1;
#pragma unroll
  for (int k = 0; k < MAX_OPS; ++k)
    if (k < nops && (const void*)ops.in[k] == (const void*)keys) key_op = k;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int d = (key[i] >> shift) & 0xFF;
    slot[i] += row[d];
    dig[slot[i]] = (unsigned char)d;
    if (pos_out != nullptr) pos_out[mine + i * 32] = adj[d] + slot[i];
    if (key_op >= 0) buf[slot[i]] = (int)key[i];
  }
  __syncthreads();

  // 2. one coalesced write per operand, the key word first
#pragma unroll
  for (int k = 0; k < MAX_OPS; ++k)
    if (k == key_op) write_slots<THREADS, ITEMS>(ops.out[k], buf, adj, dig);
  bool used = key_op >= 0;
#pragma unroll
  for (int k = 0; k < MAX_OPS; ++k) {
    if (k < nops && k != key_op) {
      const int* in = ops.in[k];
      int v[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) v[i] = in[mine + i * 32];
      if (used) __syncthreads();       // the previous operand's reads
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) buf[slot[i]] = v[i];
      __syncthreads();
      write_slots<THREADS, ITEMS>(ops.out[k], buf, adj, dig);
      used = true;
    }
  }
}

template <int WARPS, int ITEMS>
int launch(const void* keys, const void* base, int tile_stride,
           int digit_stride, int shift, int n, void* pos_out, int nops,
           const Operands& ops, cudaStream_t stream) {
  constexpr int TILE = WARPS * 32 * ITEMS;
  const int smem = (WARPS * 256 + TILE + 256 + 8) * (int)sizeof(int) + TILE;
  auto kernel = radix_pos_kernel<WARPS, ITEMS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n / TILE, WARPS * 32, smem, stream>>>(
      (const uint32_t*)keys, (const int*)base, tile_stride, digit_stride,
      shift, (int*)pos_out, ops, nops);
  return (int)cudaGetLastError();
}

}  // namespace

// base: int32 element (tile, digit) at base[tile * tile_stride + digit *
// digit_stride]; block 1024 or 8192 and dividing n
extern "C" int radix_pos_launch(const void* keys, const void* base,
                                int tile_stride, int digit_stride, int shift,
                                int n, int block, void* pos_out, int nops,
                                const void* in0, const void* in1,
                                const void* in2, const void* in3, void* out0,
                                void* out1, void* out2, void* out3,
                                void* stream) {
  if (block <= 0 || n % block || nops < 0 || nops > MAX_OPS) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  Operands ops;
  ops.in[0] = (const int*)in0;
  ops.in[1] = (const int*)in1;
  ops.in[2] = (const int*)in2;
  ops.in[3] = (const int*)in3;
  ops.out[0] = (int*)out0;
  ops.out[1] = (int*)out1;
  ops.out[2] = (int*)out2;
  ops.out[3] = (int*)out3;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 1024:
      return launch<8, 4>(keys, base, tile_stride, digit_stride, shift, n,
                          pos_out, nops, ops, s);
    case 8192:
      return launch<16, 16>(keys, base, tile_stride, digit_stride, shift, n,
                            pos_out, nops, ops, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
