// The unpacked single-batch rank kernel as it was before its redesign: one
// query a warp, each lane loading four symbols of every 128-symbol slice,
// the warp voting with __ballot_sync on (symbol == c and position < cut),
// one block of 256 threads for each 8 queries.  chip_smoke.py builds it
// beside the kernels (nvcc, plain C interface, ctypes), holds it to
// rank_select_plain and times it in turns with the port's rank_select.cu.
// It is a measurement, not a kernel of the port: no wrapper calls it and no
// launch of it is counted.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void rank_select_warp_kernel(const int* __restrict__ blocks,
                                        int r, const int* __restrict__ blk,
                                        const int* __restrict__ sym,
                                        const int* __restrict__ cut,
                                        int* __restrict__ out, int B) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = (int)(gtid >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;  // uniform per warp: blockDim is a multiple of 32
  const int* row = blocks + (size_t)blk[q] * (size_t)r;
  const int k = min(cut[q], r), c = sym[q];
  int cnt = 0;
  for (int j0 = 0; j0 < r; j0 += 128) {
    int s[4];
    bool in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + i * 32 + lane;
      in[i] = j < k && j < r;
      s[i] = in[i] ? __ldg(row + j) : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cnt += __popc(__ballot_sync(0xFFFFFFFFu, in[i] && s[i] == c));
  }
  if (lane == 0) out[q] = cnt;
}

extern "C" int rank_select_warp_launch(const void* blocks, int r,
                                       const void* blk, const void* sym,
                                       const void* cut, void* out, int B,
                                       void* stream) {
  if (B > 0) {
    const int threads = 256;  // 8 queries per block
    const long long total = (long long)B * 32;
    rank_select_warp_kernel<<<(unsigned)((total + threads - 1) / threads),
                              threads, 0, (cudaStream_t)stream>>>(
        (const int*)blocks, r, (const int*)blk, (const int*)sym,
        (const int*)cut, (int*)out, B);
  }
  return (int)cudaGetLastError();
}
