// One stable 8-bit LSD radix pass: destination of every key = digit-major
// bin base of its (block, digit) + its stable rank among the keys of its
// block with the same digit, fused with the scatter of up to four int32
// operands to that destination.
//
// Replaces: radix_pos_pallas / _pos_kernel,
//           src/repro/kernels/radix_sort.py:43-76, and the XLA scatter
//           that follows it on the TPU (radix_sort.py:110).
// Plain version: radix_pos_plain / radix_scatter_plain in
//           src/repro_torch/kernels/radix_sort.py.
//
// Bound on the H100: bytes.  Per pass over n keys with k operands: the bases
// (n bytes at 1024-key blocks) are read once, and each operand is read and
// written once (8kn).  The key word is one of the operands (the sort driver
// passes it as operand 0), so its second read hits L1 and costs no HBM
// bytes: (8k + 1) n bytes, about 2.0 ms at n = 2^28, k = 3, 3.35 TB/s.
// Writing the positions (4n) is only done when asked for.
//
// Design: stability is the hazard.  An atomic-increment scatter would put
// equal digits in arbitrary order and the suffix array would differ from
// the reference.  One CUDA block takes one key block (one key per thread,
// blockDim = block <= 1024), and the intra-block rank follows input order
// exactly:
//   1. within a warp, __match_any_sync groups the lanes holding the same
//      digit; a lane's rank is the number of lower lanes in its group;
//   2. the group's lowest lane stores the group size in a per-(warp, digit)
//      table in shared memory (32 x 256 ints = 32 KiB);
//   3. one thread per digit turns its column into an exclusive prefix over
//      the warps in order, starting from the block's global bin base;
//   4. destination = table[warp][digit] + rank-in-warp.
// The scatter writes straight from registers, so positions never round-trip
// through device memory.
#include <cstdint>
#include <cuda_runtime.h>

#define MAX_OPS 4

struct Operands {
  const int* in[MAX_OPS];
  int* out[MAX_OPS];
};

__global__ void radix_pos_kernel(const uint32_t* __restrict__ keys,
                                 const int* __restrict__ base, int shift,
                                 int* __restrict__ pos_out, Operands ops,
                                 int nops) {
  __shared__ int table[32][256];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < warps * 256; i += blockDim.x)
    table[i >> 8][i & 255] = 0;
  __syncthreads();

  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t d = (keys[i] >> shift) & 0xFFu;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (rank == 0) table[warp][d] = __popc(peers);
  __syncthreads();

  const int* brow = base + (size_t)blockIdx.x * 256;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    int run = brow[b];
    for (int w = 0; w < warps; ++w) {
      const int t = table[w][b];
      table[w][b] = run;
      run += t;
    }
  }
  __syncthreads();

  const int p = table[warp][d] + rank;
  if (pos_out != nullptr) pos_out[i] = p;
#pragma unroll
  for (int k = 0; k < MAX_OPS; ++k)
    if (k < nops) ops.out[k][p] = ops.in[k][i];
}

extern "C" int radix_pos_launch(const void* keys, const void* base, int shift,
                                int n, int block, void* pos_out, int nops,
                                const void* in0, const void* in1,
                                const void* in2, const void* in3, void* out0,
                                void* out1, void* out2, void* out3,
                                void* stream) {
  if (n > 0) {
    Operands ops;
    ops.in[0] = (const int*)in0;
    ops.in[1] = (const int*)in1;
    ops.in[2] = (const int*)in2;
    ops.in[3] = (const int*)in3;
    ops.out[0] = (int*)out0;
    ops.out[1] = (int*)out1;
    ops.out[2] = (int*)out2;
    ops.out[3] = (int*)out3;
    radix_pos_kernel<<<n / block, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)keys, (const int*)base, shift, (int*)pos_out, ops,
        nops);
  }
  return (int)cudaGetLastError();
}
