// The stacked catalog query kernel as it was before its redesign: one
// thread per (segment, pattern, slot), blockIdx.y the segment, every lane
// of a pattern repeating its backward search (the packed entry) or one
// group of 16 lanes searching per pattern and slot group (the unpacked
// entry), lane j walking row sp + j.  chip_smoke.py builds it (nvcc, plain
// C interface, ctypes) beside the port's kernels and times it in turns
// with src/repro_torch/kernels/csrc/fm_query_stacked.cu on the same
// buckets, so the redesign is measured against it within one run.  It is a
// measurement, not a kernel of the port: no wrapper calls it and no launch
// of it is counted.  Its entries take the arguments the port's stacked
// entries took before the redesign; stacked_lanes_occupancy reports its
// registers and resident blocks per SM.
#include <cstdint>
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/fm_query_common.cuh"

// What every segment shares: its bucket strides and per-segment vectors.
struct Stack {
  int n_seg;                 // real segments (<= gridDim.y = seg_pad)
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
                  st.vals, (long long)gridDim.y * st.MV, st.sa_rate, 0,
                  seg * st.MV};
}

// Pad segment: write its rows (sp = ep = 0, every position its length 0).
__device__ __forceinline__ void pad_rows(long long t, int lanes, int B,
                                         int k, size_t row0, int* sp_out,
                                         int* ep_out, int* pos_out) {
  if (t >= (long long)B * lanes) return;
  const int b = (int)(t / lanes), j = (int)(t - (long long)b * lanes);
  if (j == 0) {
    sp_out[row0 + b] = 0;
    ep_out[row0 + b] = 0;
  }
  if (j < k) pos_out[(row0 + b) * k + j] = 0;
}

template <int BITS>
__global__ void stacked_lanes_packed_kernel(
    const uint32_t* __restrict__ fused, int wid, int sigma, int r, Stack st,
    const int* __restrict__ patterns, int B, int m, int k,
    int* __restrict__ sp_out, int* __restrict__ ep_out,
    int* __restrict__ pos_out) {
  extern __shared__ int sC[];
  const int seg = blockIdx.y;
  const int lanes = max(k, 1);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row0 = (size_t)seg * B;         // this segment's output row
  if (seg >= st.n_seg) {
    pad_rows(t, lanes, B, k, row0, sp_out, ep_out, pos_out);
    return;
  }
  for (int i = threadIdx.x; i < sigma; i += blockDim.x)
    sC[i] = st.C[(size_t)seg * sigma + i];
  __syncthreads();
  if (t >= (long long)B * lanes) return;
  const int b = (int)(t / lanes), j = (int)(t - (long long)b * lanes);
  const PackedIndex ix{fused + (size_t)seg * st.NB * wid, wid, sigma,
                       wid - sigma, st.n_blocks[seg], r, st.lengths[seg]};

  int sp, ep;
  packed_search<BITS>(ix, sC, patterns + (size_t)b * m, m, sp, ep);
  if (j == 0) {
    sp_out[row0 + b] = sp;
    ep_out[row0 + b] = ep;
  }
  if (k == 0) return;
  const int row = sp + j;
  pos_out[(row0 + b) * k + j] =
      row < ep ? packed_walk<BITS>(ix, sC, segment_sample(st, seg), row)
               : ix.n;
}

__global__ void stacked_lanes_unpacked_kernel(
    const int* __restrict__ blocks, const int* __restrict__ occ, int sigma,
    int r, Stack st, const int* __restrict__ patterns, int B, int m, int k,
    int lanes, int* __restrict__ sp_out, int* __restrict__ ep_out,
    int* __restrict__ pos_out) {
  extern __shared__ int sC[];
  const int seg = blockIdx.y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row0 = (size_t)seg * B;
  if (seg >= st.n_seg) {
    pad_rows(t, lanes, B, k, row0, sp_out, ep_out, pos_out);
    return;
  }
  for (int i = threadIdx.x; i < sigma; i += blockDim.x)
    sC[i] = st.C[(size_t)seg * sigma + i];
  __syncthreads();
  // every lane of a warp takes part in the search's votes; lanes past the
  // batch search pattern B - 1 and write nothing
  const bool active = t < (long long)B * lanes;
  const int b = active ? (int)(t / lanes) : B - 1;
  const int j = active ? (int)(t - (long long)b * lanes) : lanes;
  const size_t base = (size_t)seg * st.NB;
  const UnpackedIndex ix{blocks + base * r, occ + base * sigma, sigma,
                         st.n_blocks[seg], r, st.lengths[seg]};

  int sp, ep;
  unpacked_search(ix, sC, patterns + (size_t)b * m, m, sp, ep);
  if (active && j == 0) {
    sp_out[row0 + b] = sp;
    ep_out[row0 + b] = ep;
  }
  if (j >= k) return;               // count (k = 0), spare lanes, the tail
  const int row = sp + j;
  pos_out[(row0 + b) * k + j] =
      row < ep ? unpacked_walk(ix, sC, segment_sample(st, seg), row) : ix.n;
}

extern "C" int stacked_lanes_packed_launch(
    const void* fused, int wid, int NB, int sigma, int bits, int r,
    int n_seg, int seg_pad, const void* n_blocks, const void* lengths,
    const void* C, const void* marks, const void* mark_ranks,
    const void* vals, long long MW, long long MV, int sa_rate,
    const void* patterns, int B, int m, int k, void* sp, void* ep, void* pos,
    void* stream) {
  if (B > 0 && seg_pad > 0) {
    const Stack st{n_seg, NB, (const int*)n_blocks, (const int*)lengths,
                   (const int*)C, (const uint32_t*)marks,
                   (const int*)mark_ranks, (const uint32_t*)vals, MW, MV,
                   sa_rate};
    const int threads = 128;
    const long long total = (long long)B * (k > 0 ? k : 1);
    const dim3 grid((unsigned)((total + threads - 1) / threads),
                    (unsigned)seg_pad);
    const size_t smem = (size_t)sigma * sizeof(int);
    cudaStream_t s = (cudaStream_t)stream;
    if (bits == 2)
      stacked_lanes_packed_kernel<2><<<grid, threads, smem, s>>>(
          (const uint32_t*)fused, wid, sigma, r, st, (const int*)patterns, B,
          m, k, (int*)sp, (int*)ep, (int*)pos);
    else
      stacked_lanes_packed_kernel<4><<<grid, threads, smem, s>>>(
          (const uint32_t*)fused, wid, sigma, r, st, (const int*)patterns, B,
          m, k, (int*)sp, (int*)ep, (int*)pos);
  }
  return (int)cudaGetLastError();
}

extern "C" int stacked_lanes_unpacked_launch(
    const void* blocks, const void* occ, int NB, int sigma, int r,
    int n_seg, int seg_pad, const void* n_blocks, const void* lengths,
    const void* C, const void* marks, const void* mark_ranks,
    const void* vals, long long MW, long long MV, int sa_rate,
    const void* patterns, int B, int m, int k, void* sp, void* ep, void* pos,
    void* stream) {
  if (B > 0 && seg_pad > 0) {
    const Stack st{n_seg, NB, (const int*)n_blocks, (const int*)lengths,
                   (const int*)C, (const uint32_t*)marks,
                   (const int*)mark_ranks, (const uint32_t*)vals, MW, MV,
                   sa_rate};
    const int lanes = (k > 0 ? (k + GROUP - 1) / GROUP : 1) * GROUP;
    const int threads = 128;
    const long long total = (long long)B * lanes;
    const dim3 grid((unsigned)((total + threads - 1) / threads),
                    (unsigned)seg_pad);
    stacked_lanes_unpacked_kernel<<<grid, threads,
                                       (size_t)sigma * sizeof(int),
                                       (cudaStream_t)stream>>>(
        (const int*)blocks, (const int*)occ, sigma, r, st,
        (const int*)patterns, B, m, k, lanes, (int*)sp, (int*)ep, (int*)pos);
  }
  return (int)cudaGetLastError();
}

// out = {resident blocks per SM, registers per thread, threads per block,
// local (spilled) bytes per thread} of the packed (unpacked = 0, bits 2 or
// 4) or unpacked entry's kernel with sigma ints of dynamic shared memory.
extern "C" int stacked_lanes_occupancy(int unpacked, int bits, int sigma,
                                       int* out) {
  const void* fn =
      unpacked ? (const void*)stacked_lanes_unpacked_kernel
               : (bits == 2 ? (const void*)stacked_lanes_packed_kernel<2>
                            : (const void*)stacked_lanes_packed_kernel<4>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, 128, (size_t)sigma * sizeof(int));
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = 128;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
