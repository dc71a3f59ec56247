// Where a single-batch rank_select launch spends its time: the port's
// kernel (src/repro_torch/kernels/csrc/rank_select.cu, 16-byte loads, G
// lanes a query) and the one before its redesign
// (scripts/rank_select_warp.cu, a warp a query) with clock64() stamps.
// Lane 0 of each query's group (of its warp) writes the SM cycles from
// its entry to its arguments' arrival, to its row's arrival, to its
// count, and the global timer (ns) at its entry and after its store:
//   stamps[q * 6 + {0..5}] = {args, row, sum cycles, 0, entry ns, exit ns}.
// Each stamp reads the timer with the value it waits on as an operand, so
// it cannot be taken before the load arrives.  chip_smoke.py builds it
// beside the kernels (nvcc, plain C interface, ctypes) and runs it on
// phase 1's batches; the stamps cost instructions of their own, so only
// the shares and the two kernels' differences are read.  It is a
// measurement, not a kernel of the port: no wrapper calls it and no launch
// of it is counted.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 256;

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

__device__ __forceinline__ int chunk_count(int4 x, int j, int c, int k) {
  return (j < k && x.x == c) + (j + 1 < k && x.y == c) +
         (j + 2 < k && x.z == c) + (j + 3 < k && x.w == c);
}

// The port's kernel at one query a group (no grid-stride: the batch fits
// one wave), 16-byte loads, stamped; REDUX sums the group's counts with
// one __reduce_add_sync instead of log2 G shuffles.
template <int G, bool REDUX>
__global__ void __launch_bounds__(THREADS)
    group_stamps(const int* __restrict__ blocks, int r,
                 const int* __restrict__ blk, const int* __restrict__ sym,
                 const int* __restrict__ cut, int* __restrict__ out, int B,
                 long long* __restrict__ stamps) {
  const long long e_ns = ns_after(0);
  const long long t0 = cycles_after(0);
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const uint32_t gmask =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & (32 - G));
  const unsigned q = (blockIdx.x * THREADS + threadIdx.x) / G;
  if (q >= (unsigned)B) return;
  const int b = __ldg(blk + q), c = __ldg(sym + q), k0 = __ldg(cut + q);
  const long long t1 = cycles_after(b + c + k0);
  const int* row = blocks + (size_t)b * (size_t)r;
  const int k = min(k0, r);
  int cnt = 0, got = 0;
  for (int j0 = 0; j0 < k; j0 += 8 * G) {
    const int ja = j0 + 4 * g, jb = j0 + 4 * (G + g);
    int4 xa = make_int4(0, 0, 0, 0), xb = xa;
    if (ja < k) xa = __ldg(reinterpret_cast<const int4*>(row + ja));
    if (jb < k) xb = __ldg(reinterpret_cast<const int4*>(row + jb));
    got += xa.x + xb.x;
    cnt += chunk_count(xa, ja, c, k) + chunk_count(xb, jb, c, k);
  }
  const long long t2 = cycles_after(got);
  if (REDUX) {
    cnt = (int)__reduce_add_sync(gmask, (unsigned)cnt);
  } else {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      cnt += __shfl_xor_sync(gmask, cnt, o);
  }
  const long long t3 = cycles_after(cnt);
  if (g == 0) {
    out[q] = cnt;
    long long* s = stamps + (size_t)q * 6;
    s[0] = t1 - t0;
    s[1] = t2 - t1;
    s[2] = t3 - t2;
    s[3] = 0;
    s[4] = e_ns;
    s[5] = ns_after(cnt);
  }
}

// The kernel before the redesign (a warp a query, ballots), stamped.
__global__ void warp_stamps(const int* __restrict__ blocks, int r,
                            const int* __restrict__ blk,
                            const int* __restrict__ sym,
                            const int* __restrict__ cut,
                            int* __restrict__ out, int B,
                            long long* __restrict__ stamps) {
  const long long e_ns = ns_after(0);
  const long long t0 = cycles_after(0);
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = (int)(gtid >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;
  const int b = blk[q], k = min(cut[q], r), c = sym[q];
  const long long t1 = cycles_after(b + c + k);
  const int* row = blocks + (size_t)b * (size_t)r;
  int cnt = 0, got = 0;
  for (int j0 = 0; j0 < r; j0 += 128) {
    int s[4];
    bool in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + i * 32 + lane;
      in[i] = j < k && j < r;
      s[i] = in[i] ? __ldg(row + j) : 0;
    }
    got += s[0] + s[1] + s[2] + s[3];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cnt += __popc(__ballot_sync(0xFFFFFFFFu, in[i] && s[i] == c));
  }
  const long long t2 = cycles_after(got);
  const long long t3 = cycles_after(cnt);
  if (lane == 0) {
    out[q] = cnt;
    long long* s = stamps + (size_t)q * 6;
    s[0] = t1 - t0;
    s[1] = t2 - t1;
    s[2] = t3 - t2;
    s[3] = 0;
    s[4] = e_ns;
    s[5] = ns_after(cnt);
  }
}

template <int G, bool REDUX>
static void launch_group(unsigned grid, cudaStream_t st, const int* bl,
                         int r, const int* bk, const int* sy, const int* ct,
                         int* out, int B, long long* sp) {
  group_stamps<G, REDUX><<<grid, THREADS, 0, st>>>(bl, r, bk, sy, ct, out,
                                                   B, sp);
}

// group = 0: the kernel before the redesign; 4 .. 32: the port's at that
// group size (one block of THREADS for each THREADS / group queries), its
// count summed by shuffles; 100 + group: summed by __reduce_add_sync.
extern "C" int rank_select_stamps_launch(const void* blocks, int r,
                                         const void* blk, const void* sym,
                                         const void* cut, void* out, int B,
                                         int group, void* stamps,
                                         void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* bl = (const int*)blocks;
  const int *bk = (const int*)blk, *sy = (const int*)sym,
            *ct = (const int*)cut;
  int* o = (int*)out;
  long long* sp = (long long*)stamps;
  const int G = group % 100;
  const unsigned grid =
      (unsigned)(((long long)B * (G ? G : 32) + THREADS - 1) / THREADS);
  if (group == 0) {
    warp_stamps<<<grid, THREADS, 0, st>>>(bl, r, bk, sy, ct, o, B, sp);
  } else {
    void (*fn)(unsigned, cudaStream_t, const int*, int, const int*,
               const int*, const int*, int*, int, long long*) = nullptr;
    switch (group) {
      case 4: fn = launch_group<4, false>; break;
      case 8: fn = launch_group<8, false>; break;
      case 16: fn = launch_group<16, false>; break;
      case 32: fn = launch_group<32, false>; break;
      case 104: fn = launch_group<4, true>; break;
      case 108: fn = launch_group<8, true>; break;
      case 116: fn = launch_group<16, true>; break;
      case 132: fn = launch_group<32, true>; break;
      default: return (int)cudaErrorInvalidValue;
    }
    fn(grid, st, bl, r, bk, sy, ct, o, B, sp);
  }
  return (int)cudaGetLastError();
}
