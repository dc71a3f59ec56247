// The interleave walks of the rebuild-free BWT merge, each in one launch:
// the pairwise walk (the right operand's rows LF-stepped through the left
// index) and the k-way walk (one walker lane per segment, every walked
// segment right to left in one chained pass).  Both write ins: for every
// walked row, the number of suffixes of the other operand(s) that sort
// before it, so its merged position is ins + row.
//
// Replaces: the per-step rank dispatches of the JAX package's merge walks,
//           _merge_walk (src/repro/core/bwt_merge.py:148-200) and
//           _kway_walk (:382-453), lax.fori_loops with one ops.rank_walkers
//           call per step: rank_packed_pallas (src/repro/kernels/
//           rank_select.py:133) on packed layouts, rank_select_pallas
//           (:179) on unpacked ones.
// Plain versions: merge_walk_plain / kway_walk_plain in
//           src/repro_torch/kernels/merge_walk.py.
//
// Bound on the H100: latency.  A walk is one dependent chain: each step's
// rank address comes from the previous step's rank, so the walk takes at
// least (steps) x (one dependent global load), pairwise and k-way alike:
// the walked lane's symbol sits in the row its own rank reads, and every
// other lane's row depends only on its own state, so one row fetch per
// step (plus shuffles) is the minimum chain.  The bytes are a few per
// step.  The operands of a compaction run (segments below 2^22 tokens)
// mostly sit in the 50 MB L2.
//
// Design.  Pairwise: one thread.  The right side's symbol and LF maps do
// not depend on the left, so the caller computes them in one batched rank
// launch and passes them interleaved as int2 (symbol, LF) rows; the walk
// loads the next row's pair before this step's rank, so the LF chain runs
// alongside the rank chain and each step costs one round trip.  K-way:
// for k <= 32 one warp, lane = segment, walk state in registers: the
// walked segment's lane loads the symbol and a shuffle broadcasts it, each
// lane ranks its own segment in the stacked layout, the roll of the wrap
// comparisons is a shuffle and the merged position a warp sum.  For k > 32
// the warps of one block, state in shared memory (double-buffered so one
// step needs two barriers), each thread taking lanes tid, tid + T, ...
// Both layouts: fused packed rows (2- or 4-bit fields, every load of a row
// issued before any is used, rank_common.cuh) and int32 blocks plus flat
// checkpoints (16-byte loads of the block below the cut).  The C array (the
// k-way c_mat) sits in shared memory when it fits in 48 KB, else it is read
// from global memory.  This kernel still loads the symbol first and the
// ranks after it, two round trips per k-way step.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_common.cuh"

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int VCHUNK = 16;                 // int4 loads issued together
constexpr size_t SMEM_C_MAX = 48 * 1024;   // C / c_mat in shared memory

// Rank-addressable rows: fused packed rows [n_rows, wid], or unpacked
// blocks [n_rows, r] with checkpoints occ [n_rows, sigma].
struct Rows {
  const uint32_t* fused;
  const int* blocks;
  const int* occ;
  int wid, sigma, r;
};

// Count of c among the first `cut` int32 symbols of the block at p.
__device__ __forceinline__ int unpacked_count(const int* __restrict__ p,
                                              int r, int c, int cut) {
  int cnt = 0;
  if ((r & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4* v = reinterpret_cast<const int4*>(p);
    for (int j0 = 0; j0 < cut; j0 += 4 * VCHUNK) {
      int4 x[VCHUNK];
#pragma unroll
      for (int i = 0; i < VCHUNK; ++i)
        x[i] = j0 + 4 * i < cut ? __ldg(v + j0 / 4 + i)
                                : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < VCHUNK; ++i) {
        const int j = j0 + 4 * i;
        cnt += (j < cut && x[i].x == c) + (j + 1 < cut && x[i].y == c) +
               (j + 2 < cut && x[i].z == c) + (j + 3 < cut && x[i].w == c);
      }
    }
    return cnt;
  }
  for (int j0 = 0; j0 < cut; j0 += VCHUNK) {
    int x[VCHUNK];
#pragma unroll
    for (int i = 0; i < VCHUNK; ++i)
      x[i] = j0 + i < cut ? __ldg(p + j0 + i) : 0;
#pragma unroll
    for (int i = 0; i < VCHUNK; ++i) cnt += j0 + i < cut && x[i] == c;
  }
  return cnt;
}

// Occ(c, row * r + cut): the row's checkpoint plus the in-block count.
template <int BITS>
__device__ __forceinline__ int occ_rank(const Rows& L, int row, int c,
                                        int cut) {
  if constexpr (BITS > 0) {
    return packed_rank<BITS>(L.fused + (size_t)row * L.wid, L.sigma,
                             L.wid - L.sigma, (uint32_t)c, cut);
  } else {
    const int base = __ldg(L.occ + (size_t)row * L.sigma + c);
    return base + unpacked_count(L.blocks + (size_t)row * L.r, L.r, c,
                                 min(cut, L.r));
  }
}

// Symbol j of row `row`, clipped to [0, sigma).
template <int BITS>
__device__ __forceinline__ int symbol_at(const Rows& L, int row, int j) {
  int s;
  if constexpr (BITS > 0) {
    const uint32_t w = __ldg(L.fused + (size_t)row * L.wid + L.sigma +
                             j / Packed<BITS>::FPW);
    s = (int)((w >> (BITS * (j % Packed<BITS>::FPW))) & Packed<BITS>::FIELD);
  } else {
    s = __ldg(L.blocks + (size_t)row * L.r + j);
  }
  return min(max(s, 0), L.sigma - 1);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// -- pairwise ---------------------------------------------------------------
// ends = {rowA, lastA, rowB, lastB}; clf[row] = (symbol, LF) of the right
// operand's row; ins[row] for each of its nB rows.
template <int BITS>
__global__ void pairwise_kernel(Rows A, int nbA, const int* __restrict__ cA,
                                const int* __restrict__ cB,
                                const int2* __restrict__ clf, int nB,
                                const int* __restrict__ ends,
                                int* __restrict__ ins) {
  extern __shared__ int smem[];
  const bool c_in_smem = (size_t)A.sigma * sizeof(int) <= SMEM_C_MAX;
  if (c_in_smem)
    for (int i = threadIdx.x; i < A.sigma; i += blockDim.x) smem[i] = cA[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int* C = c_in_smem ? smem : cA;
  const int rowA = ends[0], lastA = ends[1], rowB = ends[2], lastB = ends[3];
  // anchor: the length-1 suffix sorts before every longer suffix sharing
  // its first character lastB
  int I = C[lastB];
  int rr = cB[lastB];
  ins[rr] = I;
  int2 cur = __ldg(clf + rr);
  for (int t = 0; t < nB - 1; ++t) {
    const int nx = cur.y;
    const int2 ahead = __ldg(clf + nx);   // the next step's pair, first
    const int c = cur.x;
    const int corr = c == lastA ? (int)(rowB < rr) - (int)(rowA < I) : 0;
    const int blk = min(I / A.r, nbA - 1);
    I = C[c] + occ_rank<BITS>(A, blk, c, I - blk * A.r) + corr;
    ins[nx] = I;
    rr = nx;
    cur = ahead;
  }
}

// -- k-way ------------------------------------------------------------------
// Per segment s < k: C row c_mat[s], block count nb[s], BWT row of suffix 0
// row[s], last character last[s], length len[s]; segment s owns stacked
// rows [s * NB, s * NB + nb[s]).  ins holds segments 1 .. k-1 back to back
// at their real lengths.
struct Run {
  const int* c_mat;
  const int* nb;
  const int* row;
  const int* last;
  const int* len;
  int k, NB;
};

// Shared per-segment tables: lengths, last characters, ins offsets, and
// the C rows when they fit.  Returns the C rows' base.
__device__ const int* load_run(const Run& R, int sigma, int* sLen,
                               int* sLast, int* sOff, int* sCm) {
  const bool cm_in_smem = (size_t)R.k * sigma * sizeof(int) <= SMEM_C_MAX;
  for (int i = threadIdx.x; i < R.k; i += blockDim.x) {
    sLen[i] = R.len[i];
    sLast[i] = R.last[i];
  }
  if (cm_in_smem)
    for (int i = threadIdx.x; i < R.k * sigma; i += blockDim.x)
      sCm[i] = R.c_mat[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0;
    sOff[0] = 0;
    for (int s = 1; s < R.k; ++s) {
      sOff[s] = off;
      off += sLen[s];
    }
  }
  __syncthreads();
  return cm_in_smem ? sCm : R.c_mat;
}

__device__ __forceinline__ int walk_steps(const int* sLen, int k) {
  int n = 0;
  for (int s = 1; s < k; ++s) n += sLen[s];
  return n - 1;
}

__device__ __forceinline__ void record(int* ins, const int* sOff,
                                       const int* sLen, int seg, int I,
                                       int total) {
  if (I >= 0 && I < sLen[seg]) ins[sOff[seg] + I] = total - I;
}

template <int BITS>
__global__ void kway_warp_kernel(Rows S, Run R, int* __restrict__ ins) {
  extern __shared__ int smem[];
  int *sLen = smem, *sLast = sLen + R.k, *sOff = sLast + R.k,
      *sCm = sOff + R.k;
  const int* Cm = load_run(R, S.sigma, sLen, sLast, sOff, sCm);
  const int lane = threadIdx.x, k = R.k;
  const bool active = lane < k, anchor = lane == k - 1;
  const int my_row = active ? R.row[lane] : 0;
  const int my_last = active ? sLast[lane] : 0;
  const int my_nb = active ? R.nb[lane] : 1;
  const int* my_C = Cm + (size_t)(active ? lane : 0) * S.sigma;

  // anchor: U's length-1 suffix sorts before every longer suffix sharing
  // its first character, in every segment's order at once
  int seg = k - 1, pos = sLen[seg] - 1;
  int I = active ? my_C[sLast[seg]] : 0;
  int total = warp_sum(I);
  if (lane == seg) record(ins, sOff, sLen, seg, I, total);
  const int steps = walk_steps(sLen, k);
  for (int t = 0; t < steps; ++t) {
    // the symbol to prepend: the walked segment's BWT at its own rank, or
    // at a boundary the previous segment's last character
    const bool boundary = pos == 0;
    int val = my_last;
    if (!boundary && lane == seg)
      val = symbol_at<BITS>(S, seg * R.NB + min(I / S.r, R.NB - 1),
                            I % S.r);
    const int c = __shfl_sync(FULL, val, boundary ? seg - 1 : seg);
    // wrap corrections from the pre-update states: the lane after this
    // one (the anchor lane: nothing, which sorts first)
    const int cmp = my_row < I;
    int nxt = __shfl_down_sync(FULL, cmp, 1);
    if (anchor) nxt = 1;
    const int corr = my_last == c ? nxt - cmp : 0;
    int I_new = 0;
    if (active) {
      const int blk = min(I / S.r, my_nb - 1);
      I_new = my_C[c] + occ_rank<BITS>(S, lane * R.NB + blk, c,
                                        I - blk * S.r) + corr;
    }
    I = I_new;
    total = warp_sum(I);
    if (boundary) {
      --seg;
      pos = sLen[seg] - 1;
    } else {
      --pos;
    }
    if (lane == seg) record(ins, sOff, sLen, seg, I, total);
  }
}

template <int BITS>
__global__ void kway_block_kernel(Rows S, Run R, int* __restrict__ ins) {
  extern __shared__ int smem[];
  const int k = R.k, T = blockDim.x, tid = threadIdx.x;
  int *sI0 = smem, *sI1 = sI0 + k, *sRow = sI1 + k, *sNb = sRow + k,
      *sPart = sNb + k, *sSym = sPart + 32, *sLen = sSym + 1,
      *sLast = sLen + k, *sOff = sLast + k, *sCm = sOff + k;
  for (int i = tid; i < k; i += T) {
    sRow[i] = R.row[i];
    sNb[i] = R.nb[i];
  }
  const int* Cm = load_run(R, S.sigma, sLen, sLast, sOff, sCm);
  const int warp = tid >> 5, lane32 = tid & 31, n_warps = (T + 31) >> 5;

  int seg = k - 1, pos = sLen[seg] - 1;
  int part = 0;
  for (int l = tid; l < k; l += T) {
    sI0[l] = Cm[(size_t)l * S.sigma + sLast[seg]];
    part += sI0[l];
  }
  part = warp_sum(part);
  if (lane32 == 0) sPart[warp] = part;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < n_warps; ++w) total += sPart[w];
  if (tid == seg % T) record(ins, sOff, sLen, seg, sI0[seg], total);

  int *cur = sI0, *nxt_buf = sI1;
  const int steps = walk_steps(sLen, k);
  for (int t = 0; t < steps; ++t) {
    const bool boundary = pos == 0;
    if (!boundary && tid == seg % T) {
      const int I = cur[seg];
      *sSym = symbol_at<BITS>(S, seg * R.NB + min(I / S.r, R.NB - 1),
                              I % S.r);
    }
    __syncthreads();
    const int c = boundary ? sLast[seg - 1] : *sSym;
    part = 0;
    for (int l = tid; l < k; l += T) {
      const int I = cur[l];
      const int cmp = sRow[l] < I;
      const int nxt = l == k - 1 ? 1 : (int)(sRow[l + 1] < cur[l + 1]);
      const int corr = sLast[l] == c ? nxt - cmp : 0;
      const int blk = min(I / S.r, sNb[l] - 1);
      const int I_new = Cm[(size_t)l * S.sigma + c] +
                        occ_rank<BITS>(S, l * R.NB + blk, c, I - blk * S.r) +
                        corr;
      nxt_buf[l] = I_new;
      part += I_new;
    }
    part = warp_sum(part);
    if (lane32 == 0) sPart[warp] = part;
    __syncthreads();
    if (boundary) {
      --seg;
      pos = sLen[seg] - 1;
    } else {
      --pos;
    }
    if (tid == seg % T) {
      total = 0;
      for (int w = 0; w < n_warps; ++w) total += sPart[w];
      record(ins, sOff, sLen, seg, nxt_buf[seg], total);
    }
    int* sw = cur;
    cur = nxt_buf;
    nxt_buf = sw;
  }
}

extern "C" int merge_walk_launch(const void* fusedA, const void* blocksA,
                                 const void* occA, int wid, int nbA,
                                 int sigma, int bits, int r, const void* cA,
                                 const void* cB, const void* clf, int nB,
                                 const void* ends, void* ins, void* stream) {
  if (nB > 0) {
    Rows A{(const uint32_t*)fusedA, (const int*)blocksA, (const int*)occA,
           wid, sigma, r};
    const size_t smem =
        (size_t)sigma * sizeof(int) <= SMEM_C_MAX ? sigma * sizeof(int) : 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int2* p = (const int2*)clf;
    if (bits == 2)
      pairwise_kernel<2><<<1, 32, smem, st>>>(A, nbA, (const int*)cA,
                                              (const int*)cB, p, nB,
                                              (const int*)ends, (int*)ins);
    else if (bits == 4)
      pairwise_kernel<4><<<1, 32, smem, st>>>(A, nbA, (const int*)cA,
                                              (const int*)cB, p, nB,
                                              (const int*)ends, (int*)ins);
    else
      pairwise_kernel<0><<<1, 32, smem, st>>>(A, nbA, (const int*)cA,
                                              (const int*)cB, p, nB,
                                              (const int*)ends, (int*)ins);
  }
  return (int)cudaGetLastError();
}

extern "C" int merge_walk_kway_launch(const void* fused, const void* blocks,
                                      const void* occ, int wid, int NB,
                                      int sigma, int bits, int r,
                                      const void* c_mat, const void* nb,
                                      const void* row, const void* last,
                                      const void* len, int k, void* ins,
                                      void* stream) {
  if (k >= 2) {
    Rows S{(const uint32_t*)fused, (const int*)blocks, (const int*)occ, wid,
           sigma, r};
    Run R{(const int*)c_mat, (const int*)nb, (const int*)row,
          (const int*)last, (const int*)len, k, NB};
    const size_t cm = (size_t)k * sigma * sizeof(int);
    const size_t cm_smem = cm <= SMEM_C_MAX ? cm : 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (k <= 32) {
      const size_t smem = 3 * (size_t)k * sizeof(int) + cm_smem;
      if (bits == 2)
        kway_warp_kernel<2><<<1, 32, smem, st>>>(S, R, (int*)ins);
      else if (bits == 4)
        kway_warp_kernel<4><<<1, 32, smem, st>>>(S, R, (int*)ins);
      else
        kway_warp_kernel<0><<<1, 32, smem, st>>>(S, R, (int*)ins);
    } else {
      const int threads = k < 1024 ? ((k + 31) / 32) * 32 : 1024;
      const size_t smem = (7 * (size_t)k + 33) * sizeof(int) + cm_smem;
      if (smem > 48 * 1024) {
        const void* fn =
            bits == 2 ? (const void*)kway_block_kernel<2>
                      : bits == 4 ? (const void*)kway_block_kernel<4>
                                  : (const void*)kway_block_kernel<0>;
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
      }
      if (bits == 2)
        kway_block_kernel<2><<<1, threads, smem, st>>>(S, R, (int*)ins);
      else if (bits == 4)
        kway_block_kernel<4><<<1, threads, smem, st>>>(S, R, (int*)ins);
      else
        kway_block_kernel<0><<<1, threads, smem, st>>>(S, R, (int*)ins);
    }
  }
  return (int)cudaGetLastError();
}
