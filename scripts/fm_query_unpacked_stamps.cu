// Where a locate walk step of the fused unpacked query kernel spends its
// time: the lane-serial walk of the design before the redesign
// (scripts/fm_query_unpacked_serial.cu: lane j walks row sp + j alone, its
// block's symbols as 4-byte loads, SPAN at a time) and the group walk of
// src/repro_torch/kernels/csrc/fm_query_unpacked.cu (G lanes a row, the
// block's chunks as 16-byte loads, the count summed by shuffles, or by
// ballots as the kernel's first version did; here the row's symbol is a
// load of its own, where the kernel takes it from the lane that loaded
// its chunk), each with clock64() stamps around its two round trips a
// step.  The rows to walk are given (rows[b * k + j], -1 for none), laid
// out over the lanes as each kernel lays them out: the serial walk's
// lanes in groups of 16 a pattern (k rounded up to 16), the group walk's
// G lanes a row.  For each row, the lane (or the group's lane 0) that
// walks it writes
//   stamps[(b * k + j) * 6 + {0..5}] =
//     {steps, round trip 1 cycles, round trip 2 cycles, walk cycles,
//      entry ns, exit ns}:
// round trip 1 is a step's first loads (the mark word and rank, the symbol
// and the block below the cut; for the serial walk its first SPAN
// symbols) from issue to arrival, round trip 2 the rest of the step (the
// checkpoint, and the serial walk's later symbols) to the next row.  Each
// stamp reads the clock with the value it waits on as an operand, so it
// cannot be taken before the load arrives; the stamps cost instructions
// and order the loads around them, so only the shares and the designs'
// differences are read.  chip_smoke.py builds it beside the kernels and
// runs it on phase 16's english batches.  It is a measurement, not a
// kernel of the port: no wrapper calls it and no launch of it is counted.
#include <cstdint>
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/fm_query_common.cuh"

constexpr int THREADS = 128;

__device__ __forceinline__ long long cycles_after(int v) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(v) : "memory");
  return t;
}

__device__ __forceinline__ long long ns_after(int v) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "r"(v) : "memory");
  return t;
}

// The serial walk of one row by one lane, stamped (unpacked_walk and its
// lf_step, as fm_query_common.cuh has them).
__device__ void serial_walk(const UnpackedIndex& ix, const int* C,
                            const SaSample& sa, int row,
                            long long* __restrict__ st) {
  const long long e_ns = ns_after(row);
  const long long w0 = cycles_after(row);
  long long rt1 = 0, rt2 = 0;
  int steps = 0, pos = 0;
  for (; steps < sa.rate; ++steps) {
    const long long t0 = cycles_after(row);
    const int w = row >> 5, bit = row & 31;
    const uint32_t mw = __ldg(sa.marks + w);
    const int mr = __ldg(sa.mark_ranks + w);
    const int blk = row / ix.r, cut = row - blk * ix.r;
    const int* bp = ix.bwt + (size_t)blk * ix.r;
    int s[SPAN];
#pragma unroll
    for (int i = 0; i < SPAN; ++i) s[i] = i < cut ? __ldg(bp + i) : 0;
    const int c = __ldg(bp + cut);
    int got = c + (int)mw + mr;
#pragma unroll
    for (int i = 0; i < SPAN; ++i) got += s[i];
    const long long t1 = cycles_after(got);
    if ((mw >> bit) & 1u) {
      rt1 += t1 - t0;
      pos = sa_value(sa, mw, mr, bit) + steps;
      break;
    }
    const int base = __ldg(ix.occ + (size_t)blk * ix.sigma + c);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < SPAN; ++i) cnt += i < cut && s[i] == c;
    for (int j0 = SPAN; j0 < cut; j0 += SPAN) {
#pragma unroll
      for (int i = 0; i < SPAN; ++i)
        s[i] = j0 + i < cut ? __ldg(bp + j0 + i) : 0;
#pragma unroll
      for (int i = 0; i < SPAN; ++i) cnt += j0 + i < cut && s[i] == c;
    }
    row = __ldg(C + c) + base + cnt;
    const long long t2 = cycles_after(row);
    rt1 += t1 - t0;
    rt2 += t2 - t1;
  }
  const long long w1 = cycles_after(pos);
  st[0] = steps < sa.rate ? steps + 1 : steps;  // steps taken
  st[1] = rt1;
  st[2] = rt2;
  st[3] = w1 - w0;
  st[4] = e_ns;
  st[5] = ns_after(pos);
}

__global__ void serial_stamps(UnpackedIndex ix, const int* C, SaSample sa,
                              const int* __restrict__ rows, int B, int k,
                              int lanes, long long* __restrict__ stamps) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * lanes) return;
  const int b = (int)(t / lanes), j = (int)(t - (long long)b * lanes);
  if (j >= k) return;
  const int row = __ldg(rows + (size_t)b * k + j);
  if (row >= 0) serial_walk(ix, C, sa, row, stamps + ((size_t)b * k + j) * 6);
}

// The group walk of one row by this lane's group of G, stamped (the
// port's group_walk, 16-byte chunk loads): its count summed by log2 G
// shuffles over the group's lanes, or (BALLOT) by a ballot over them per
// chunk component.
template <int G, bool BALLOT>
__device__ void group_walk(const UnpackedIndex& ix, const int* C,
                           const SaSample& sa, int row, int g,
                           uint32_t gmask, long long* __restrict__ st) {
  const long long e_ns = ns_after(row);
  const long long w0 = cycles_after(row);
  long long rt1 = 0, rt2 = 0;
  int steps = 0, pos = 0;
  for (; steps < sa.rate; ++steps) {
    const long long t0 = cycles_after(row);
    const int blk = row / ix.r, cut = row - blk * ix.r;
    const int* bp = ix.bwt + (size_t)blk * ix.r;
    const uint32_t mw = __ldg(sa.marks + (row >> 5));
    const int mr = __ldg(sa.mark_ranks + (row >> 5));
    const int c = __ldg(bp + cut);
    int cnt = 0, got = c + (int)mw + mr;
    for (int j0 = 0; j0 < cut; j0 += 8 * G) {
      const int ja = j0 + 4 * g, jb = j0 + 4 * (G + g);
      int4 xa = make_int4(0, 0, 0, 0), xb = xa;
      if (ja < cut) xa = __ldg(reinterpret_cast<const int4*>(bp + ja));
      if (jb < cut) xb = __ldg(reinterpret_cast<const int4*>(bp + jb));
      got += xa.x + xb.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = i == 0 ? xa.x : i == 1 ? xa.y : i == 2 ? xa.z : xa.w;
        const int d = i == 0 ? xb.x : i == 1 ? xb.y : i == 2 ? xb.z : xb.w;
        if (BALLOT)
          cnt += __popc(__ballot_sync(gmask, ja + i < cut && a == c) &
                        gmask) +
                 __popc(__ballot_sync(gmask, jb + i < cut && d == c) & gmask);
        else
          cnt += (ja + i < cut && a == c) + (jb + i < cut && d == c);
      }
    }
    if (!BALLOT) {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        cnt += __shfl_xor_sync(gmask, cnt, o);
    }
    const long long t1 = cycles_after(got + cnt);
    if ((mw >> (row & 31)) & 1u) {
      rt1 += t1 - t0;
      pos = sa_value(sa, mw, mr, row & 31) + steps;
      break;
    }
    row = __ldg(C + c) + __ldg(ix.occ + (size_t)blk * ix.sigma + c) + cnt;
    const long long t2 = cycles_after(row);
    rt1 += t1 - t0;
    rt2 += t2 - t1;
  }
  const long long w1 = cycles_after(pos);
  if (g == 0) {
    st[0] = steps < sa.rate ? steps + 1 : steps;  // steps taken
    st[1] = rt1;
    st[2] = rt2;
    st[3] = w1 - w0;
    st[4] = e_ns;
    st[5] = ns_after(pos);
  }
}

template <int G, bool BALLOT>
__global__ void group_stamps(UnpackedIndex ix, const int* C, SaSample sa,
                             const int* __restrict__ rows, int B, int k,
                             long long* __restrict__ stamps) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long u = t / G;
  if (u >= (long long)B * k) return;
  const int lane = threadIdx.x & 31, g = lane & (G - 1);
  const uint32_t gmask = ((1u << G) - 1u) << (lane & (32 - G));
  const int row = __ldg(rows + u);
  if (row >= 0)
    group_walk<G, BALLOT>(ix, C, sa, row, g, gmask, stamps + u * 6);
}

// design = 0: the serial walk (16 lanes a pattern per 16 rows); 8 or 16:
// the group walk at that group size (one block of THREADS for each
// THREADS / G rows), 108 or 116 the same summed by ballots.  The blocks
// must be 16-byte aligned with r % 4 == 0 for the group walk (refused
// otherwise).
extern "C" int fm_query_unpacked_stamps_launch(
    const void* bwt, const void* occ, int n_blocks, int sigma, int r, int n,
    const void* C, const void* marks, const void* mark_ranks,
    const void* vals, int n_vals, int sa_rate, int val_bits,
    const void* rows, int B, int k, int design, void* stamps, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  UnpackedIndex ix{(const int*)bwt, (const int*)occ, sigma, n_blocks, r, n};
  SaSample sa{(const uint32_t*)marks, (const int*)mark_ranks,
              (const uint32_t*)vals, n_vals, sa_rate, val_bits, 0};
  const cudaStream_t st = (cudaStream_t)stream;
  const long long units = (long long)B * k;
  if (design == 0) {
    const int lanes = (k + GROUP - 1) / GROUP * GROUP;
    const unsigned grid =
        (unsigned)(((long long)B * lanes + THREADS - 1) / THREADS);
    serial_stamps<<<grid, THREADS, 0, st>>>(ix, (const int*)C, sa,
                                            (const int*)rows, B, k, lanes,
                                            (long long*)stamps);
  } else if (design % 100 == 8 || design % 100 == 16) {
    if (((uintptr_t)bwt & 15) != 0 || r % 4 != 0)
      return (int)cudaErrorInvalidValue;
    const int G = design % 100;
    const unsigned grid = (unsigned)((units * G + THREADS - 1) / THREADS);
    const int* C_ = (const int*)C;
    const int* rows_ = (const int*)rows;
    long long* out = (long long*)stamps;
    switch (design) {
      case 8: group_stamps<8, false><<<grid, THREADS, 0, st>>>(
                  ix, C_, sa, rows_, B, k, out); break;
      case 16: group_stamps<16, false><<<grid, THREADS, 0, st>>>(
                   ix, C_, sa, rows_, B, k, out); break;
      case 108: group_stamps<8, true><<<grid, THREADS, 0, st>>>(
                    ix, C_, sa, rows_, B, k, out); break;
      case 116: group_stamps<16, true><<<grid, THREADS, 0, st>>>(
                    ix, C_, sa, rows_, B, k, out); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
