// Per-block 256-bin histograms of the 8-bit digit (key >> shift) & 0xFF:
// the counting pass of the LSD radix local sort.
//
// Replaces: radix_hist_pallas / _kernel,
//           src/repro/kernels/radix_hist.py:18-45.
// Plain version: radix_hist_plain in src/repro_torch/kernels/radix_hist.py.
//
// Bound on the H100: bytes.  Each key is read once (4n bytes) and each
// block writes one 1 KiB row (n bytes at 1024-key blocks): 5n bytes, about
// 0.4 ms at n = 2^28 and 3.35 TB/s.
//
// Design: the TPU kernel compared a (block, 256) one-hot in VMEM.  Here one
// CUDA block of 256 threads takes one key block, counts digits into a
// 256-bin histogram in shared memory with shared-memory atomics (order does
// not matter for a count), and writes the row out.  Rows are independent,
// so the sequential TPU grid needs no carry here.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void radix_hist_kernel(const uint32_t* __restrict__ keys,
                                  int shift, int block,
                                  int* __restrict__ hist) {
  __shared__ int h[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const uint32_t* k = keys + (size_t)blockIdx.x * (size_t)block;
  for (int i = threadIdx.x; i < block; i += blockDim.x)
    atomicAdd(&h[(k[i] >> shift) & 0xFFu], 1);
  __syncthreads();
  int* row = hist + (size_t)blockIdx.x * 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) row[i] = h[i];
}

extern "C" int radix_hist_launch(const void* keys, int shift, int n,
                                 int block, void* hist, void* stream) {
  if (n > 0) {
    radix_hist_kernel<<<n / block, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)keys, shift, block, (int*)hist);
  }
  return (int)cudaGetLastError();
}
