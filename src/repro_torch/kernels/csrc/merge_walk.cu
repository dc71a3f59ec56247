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
//           src/repro_torch/kernels/merge_walk.py; the chained design's
//           plain model is chained_walk there.
//
// Bound on the H100: bytes (kernels/traffic.py walk_bytes, which the
// wrappers report): one 32-byte sector per step and the walk's inputs and
// output once.  Latency floor of this design: the longest chain's steps,
// its seed's bounding walk included, times one dependent load (a step is
// one round trip).  That is a floor of the design, not of the function:
// a walk split into more chains has a lower one.
//
// Design.  A step with its symbol c fixed maps every lane's state I to
// C[c] + Occ(c, I) + corr, monotone non-decreasing in every lane's I (the
// wrap term falls by one exactly where Occ rises by one; the neighbour's
// term rises with its I).  The walked operand's own rows and symbols do
// not depend on the other operands: the caller gives each walked row's
// (symbol, LF) pair (clf, one batched rank launch per walk) and the SA
// sample gives the own row at every 32nd text position (the caller lays
// those rows out by position; each thread finds its seed from the
// segments' lengths and the stride).  So a walk is cut
// into chains.  A seed starts at such a row, a known (step, own row), and
// runs two bounding walks over the other lanes, one from all zeros and
// one from all lengths, on the same symbols, with the walked lane held at
// its exact own row; where they meet in every lane they equal the exact
// walk from that step on.  A seed fails when they have not met at the end
// of its window, the next seed's step (a seed at position p >= stride
// never crosses its segment's boundary).  Chain 0 starts at the anchor; the
// chain of a met seed walks exactly from its meeting step, writes ins for
// its steps, and runs the bounding walks of the seeds after its own
// alongside (their loads issued with its own), so it stops exactly where
// the next met seed takes over: one launch, no wait on another chain, a
// failed seed absorbed by the chain before it.  If no seed meets the walk
// is one chain, as a walk of a repeated document is.
//
// Per step, c and the next own row come from the clf pair loaded one step
// ahead (an LF chain beside the rank chain), so a lane's rank address
// depends only on its own I: the checkpoint word and the row's packed
// words (or int32 block below the cut, 16-byte loads) of the exact walk
// and of both bounds are issued together, one round trip a step (a step
// with no seed under way runs the exact walk alone: fewer instructions;
// unpacked, the nearer checkpoint bounds a count at r / 2 symbols); I / r
// is a shift for power-of-two r; ins's sum over the lanes is taken after
// the loads are issued, off the chain.  Latency is hidden across chains: one
// chain a thread pairwise, one a group of k_pad lanes k-way (k <= 32;
// 32 / k_pad chains a warp), the seed stride sized by
// merge_walk.walk_plan so that every chain is resident in one wave
// (merge_walk_occupancy).  For k > 32 the warps of one block walk one
// chain, state in shared memory (double-buffered, one barrier a step),
// symbols from clf.  Both layouts: fused packed rows (2- or 4-bit fields)
// and int32 blocks plus flat checkpoints.  C (the k-way c_mat) sits in
// shared memory when it fits in 48 KB.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_common.cuh"

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int THREADS = 128;               // threads a block (chained kernels)
constexpr int VCHUNK = 8;                  // int4 loads a walk issues together
constexpr size_t SMEM_C_MAX = 48 * 1024;   // C / c_mat in shared memory

// Rank-addressable rows: fused packed rows [n_rows, wid], or unpacked
// blocks [n_rows, r] with checkpoints occ [n_rows, sigma]; shift = log2(r)
// for a power of two, else -1.
struct Rows {
  const uint32_t* fused;
  const int* blocks;
  const int* occ;
  int wid, sigma, r, shift;
  bool vec;   // unpacked blocks readable as int4
};

__device__ __forceinline__ void locate(const Rows& L, int I, int nb, int& blk,
                                       int& cut) {
  const int b = L.shift >= 0 ? I >> L.shift : I / L.r;
  blk = min(b, nb - 1);
  cut = I - blk * L.r;
}

// The seeds: one at every position p = q * stride > 0 of each walked
// segment but the anchor's step 0, in step order (segment k-1's from its
// largest q down, then segment k-2's, ...).  A segment's position p is
// step last - p of the walk (its position 0 is its last step), so a
// seed's window of stride steps never passes its segment; its own row is
// the SA sample's at p: rows[row0 + q * per], per = stride / rate.
struct Seeding {
  const int* rows;   // own rows at positions 0, rate, 2 rate, ... of each
                     // walked segment, segment 1 first
  int stride, per, n;
};

// Seeds of a walked segment of len rows (in the first walked segment the
// last row, p = len - 1, is the anchor's step 0).
__device__ __forceinline__ int seeds_in(int len, int stride, bool first) {
  int q = stride > 0 ? (len - 1) / stride : 0;
  if (first && q > 0 && q * stride == len - 1) --q;
  return q;
}

// Occ(c, row * r + cut[e]) for the N walks e with on[e]: every walk's
// checkpoint word and first chunk of row words are loaded before any is
// used, then between() runs (work off the chain; every lane of a warp
// reaches it at the same point, so it may shuffle), then the counts and
// any further chunks.  Packed rows: the words below the cut (one chunk
// of 8 at r = 64, 4-bit).  Unpacked blocks: the nearer checkpoint, so at
// most r / 2 symbols (16-byte loads): below the cut from this block's,
// or from the cut up, subtracted from the next block's (tot[e], the
// segment's count of c, after its last block; -1 elsewhere).
template <int BITS, int N, typename F>
__device__ __forceinline__ void ranks(const Rows& L, const int (&row)[N],
                                      const bool (&on)[N], int c,
                                      const int (&cut)[N],
                                      const int (&tot)[N], int (&out)[N],
                                      F&& between) {
  int base[N], cnt[N];
  if constexpr (BITS > 0) {
    constexpr int FPW = Packed<BITS>::FPW;
    const uint32_t pat = (uint32_t)c * Packed<BITS>::REP;
    const uint32_t* p[N];
    int words[N], wmax = 0;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      p[e] = L.fused + (size_t)row[e] * L.wid + L.sigma;
      words[e] = on[e] ? (cut[e] + FPW - 1) / FPW : 0;
      wmax = max(wmax, words[e]);
      base[e] = on[e] ? (int)__ldg(p[e] - L.sigma + c) : 0;
      cnt[e] = 0;
    }
    uint32_t x[N][CHUNK];
    auto load = [&](int w0) {
#pragma unroll
      for (int e = 0; e < N; ++e)
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
          x[e][i] = w0 + i < words[e] ? __ldg(p[e] + w0 + i) : 0u;
    };
    auto count = [&](int w0) {
#pragma unroll
      for (int e = 0; e < N; ++e)
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
          cnt[e] += word_count<BITS>(x[e][i], w0 + i, pat, cut[e] / FPW,
                                     part_mask<BITS>(cut[e]));
    };
    load(0);
    between();
    count(0);
    for (int w0 = CHUNK; w0 < wmax; w0 += CHUNK) {
      load(w0);
      count(w0);
    }
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = base[e] + cnt[e];
  } else {
    // symbols [lo, hi) of the block counted from lo & ~3 (vec) or lo
    constexpr int VC = N == 1 ? VCHUNK : VCHUNK / 2;
    const int* p[N];
    int lo[N], hi[N], from[N], span = 0;
    bool up[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      up[e] = 2 * cut[e] > L.r;
      p[e] = L.blocks + (size_t)row[e] * L.r;
      lo[e] = up[e] ? cut[e] : 0;
      hi[e] = on[e] ? (up[e] ? L.r : cut[e]) : lo[e];
      from[e] = L.vec ? lo[e] & ~3 : lo[e];
      span = max(span, hi[e] - from[e]);
      base[e] = !on[e] ? 0
                : !up[e] ? __ldg(L.occ + (size_t)row[e] * L.sigma + c)
                : tot[e] >= 0 ? tot[e]
                              : __ldg(L.occ + (size_t)(row[e] + 1) * L.sigma +
                                      c);
      cnt[e] = 0;
    }
    if (L.vec) {
      int4 x[N][VC];
      auto load = [&](int j0) {
#pragma unroll
        for (int e = 0; e < N; ++e)
#pragma unroll
          for (int i = 0; i < VC; ++i)
            x[e][i] = from[e] + j0 + 4 * i < hi[e]
                          ? __ldg(reinterpret_cast<const int4*>(p[e] +
                                                                from[e]) +
                                  j0 / 4 + i)
                          : make_int4(-1, -1, -1, -1);
      };
      auto count = [&](int j0) {
#pragma unroll
        for (int e = 0; e < N; ++e)
#pragma unroll
          for (int i = 0; i < VC; ++i) {
            const int j = from[e] + j0 + 4 * i;
            const int4 v = x[e][i];
            cnt[e] += (j >= lo[e] && j < hi[e] && v.x == c) +
                      (j + 1 >= lo[e] && j + 1 < hi[e] && v.y == c) +
                      (j + 2 >= lo[e] && j + 2 < hi[e] && v.z == c) +
                      (j + 3 >= lo[e] && j + 3 < hi[e] && v.w == c);
          }
      };
      load(0);
      between();
      count(0);
      for (int j0 = 4 * VC; j0 < span; j0 += 4 * VC) {
        load(j0);
        count(j0);
      }
    } else {
      int x[N][4 * VC];
      auto load = [&](int j0) {
#pragma unroll
        for (int e = 0; e < N; ++e)
#pragma unroll
          for (int i = 0; i < 4 * VC; ++i)
            x[e][i] = from[e] + j0 + i < hi[e] ? __ldg(p[e] + from[e] + j0 + i)
                                               : -1;
      };
      auto count = [&](int j0) {
#pragma unroll
        for (int e = 0; e < N; ++e)
#pragma unroll
          for (int i = 0; i < 4 * VC; ++i)
            cnt[e] += from[e] + j0 + i < hi[e] && x[e][i] == c;
      };
      load(0);
      between();
      count(0);
      for (int j0 = 4 * VC; j0 < span; j0 += 4 * VC) {
        load(j0);
        count(j0);
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = up[e] ? base[e] - cnt[e]
                                               : base[e] + cnt[e];
  }
}

// The segment's count of symbol c (the checkpoint after its last block)
// from its C row and length.
__device__ __forceinline__ int total_of(const int* C, int sigma, int n,
                                        int c) {
  return (c + 1 < sigma ? C[c + 1] : n) - C[c];
}

// -- pairwise ---------------------------------------------------------------
// ends = {rowA, lastA, rowB, lastB}; clf[row] = (symbol, LF) of the right
// operand's row; ins[row] for each of its nB rows.  Chain i + 1 starts at
// seed i; meets[i] is its meeting step or -1 (when meets is not null).

// One step of N walks of the left lane's state X (on: which are live),
// symbol c, right own row rr (before the step); between() runs once the
// step's loads are issued.
template <int BITS, int N, typename F>
__device__ __forceinline__ void pair_step(const Rows& A, int nbA,
                                          const int* C, int c, int lastA,
                                          int rowA, int bcmp, int (&X)[N],
                                          const bool (&on)[N], F&& between) {
  int row[N], cut[N], tot[N], occ[N];
  const int totc = BITS ? 0 : total_of(C, A.sigma, nbA * A.r, c);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    locate(A, X[e], nbA, row[e], cut[e]);
    tot[e] = row[e] == nbA - 1 ? totc : -1;
  }
  ranks<BITS, N>(A, row, on, c, cut, tot, occ, between);
  const int Cc = C[c];
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (on[e])
      X[e] = Cc + occ[e] + (c == lastA ? bcmp - (int)(rowA < X[e]) : 0);
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    pairwise_kernel(Rows A, int nbA, const int* __restrict__ cA,
                    const int* __restrict__ cB, const int2* __restrict__ clf,
                    int nB, const int* __restrict__ ends, Seeding Sd,
                    int* __restrict__ meets, int* __restrict__ ins) {
  extern __shared__ int smem[];
  const bool c_in_smem = (size_t)A.sigma * sizeof(int) <= SMEM_C_MAX;
  if (c_in_smem)
    for (int i = threadIdx.x; i < A.sigma; i += blockDim.x) smem[i] = cA[i];
  __syncthreads();
  const int chain = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_seeds = Sd.n;
  if (chain > n_seeds) return;
  // seed i: q = top - i, at step last_step - q * stride
  const int top = seeds_in(nB, Sd.stride, true);
  const int* C = c_in_smem ? smem : cA;
  const int rowA = ends[0], lastA = ends[1], rowB = ends[2], lastB = ends[3];
  const int nA = nbA * A.r, last_step = nB - 1;
  auto nothing = [] {};
  int t, rr, I;
  int2 pair;
  if (chain == 0) {
    // anchor: the length-1 suffix sorts before every longer suffix sharing
    // its first character lastB
    t = 0;
    rr = cB[lastB];
    I = C[lastB];
    pair = __ldg(clf + rr);
  } else {
    const int q = top - (chain - 1);
    t = last_step - q * Sd.stride;
    rr = __ldg(Sd.rows + q * Sd.per);
    pair = __ldg(clf + rr);
    int X[2] = {0, nA};
    const bool both[2] = {true, true};
    bool met = false;
    const int wend = t + Sd.stride;
    while (t < wend) {
      const int2 ahead = __ldg(clf + pair.y);
      pair_step<BITS, 2>(A, nbA, C, pair.x, lastA, rowA, rowB < rr, X, both,
                         nothing);
      rr = pair.y;
      pair = ahead;
      ++t;
      if (X[0] == X[1]) {
        met = true;
        break;
      }
    }
    if (meets) meets[chain - 1] = met ? t : -1;
    if (!met) return;
    I = X[0];
  }
  // the exact chain from step t, the following seeds' bounds alongside
  int j = chain;
  int nxt = j < n_seeds ? last_step - (top - j) * Sd.stride : INT_MAX;
  int X[3] = {I, 0, 0};
  bool bounds = false;                   // a seed's bounds under way
  const bool all[3] = {true, true, true}, one[1] = {true};
  for (;;) {
    if (!bounds && t == nxt) {
      bounds = true;
      X[1] = 0;
      X[2] = nA;
    }
    if (t == last_step) {
      ins[rr] = X[0];
      break;
    }
    const int2 ahead = __ldg(clf + pair.y);
    const int r_now = rr, I_now = X[0];
    auto record = [&] { ins[r_now] = I_now; };
    if (bounds) {                         // the exact walk and both bounds
      pair_step<BITS, 3>(A, nbA, C, pair.x, lastA, rowA, rowB < rr, X, all,
                         record);
    } else {                              // the exact walk alone
      int X1[1] = {X[0]};
      pair_step<BITS, 1>(A, nbA, C, pair.x, lastA, rowA, rowB < rr, X1, one,
                         record);
      X[0] = X1[0];
    }
    rr = pair.y;
    pair = ahead;
    ++t;
    if (bounds) {
      if (X[1] == X[2]) break;            // that seed's chain records t on
      if (t == nxt + Sd.stride) {         // it failed: walk on through it
        bounds = false;
        ++j;
        nxt = j < n_seeds ? last_step - (top - j) * Sd.stride : INT_MAX;
      }
    }
  }
}

// -- k-way ------------------------------------------------------------------
// Per segment s < k: C row c_mat[s], block count nb[s], BWT row of suffix 0
// row[s], last character last[s], length len[s]; segment s owns stacked
// rows [s * NB, s * NB + nb[s]).  ins (and clf) hold segments 1 .. k-1
// back to back at their real lengths; segment s is walked over steps
// [end[s + 1] + 1, end[s]] (end[k] = -1), the last one end[1] = steps;
// its seeds are [seed0[s], seed0[s] + nseed[s]), its SA-sampled own rows
// start at row0[s] of the seeding's rows.
struct Run {
  const int* c_mat;
  const int* nb;
  const int* row;
  const int* last;
  const int* len;
  int k, NB, G;   // G: lanes a chain (k_pad), k <= 32
};

// Shared per-segment tables: lengths, last characters, ins offsets, each
// segment's last step, its seeds (sSeed: seed0, nseed and row0, k each;
// none when null), and the C rows when they fit.  Returns the C rows'
// base.
__device__ const int* load_run(const Run& R, int sigma, int* sLen,
                               int* sLast, int* sOff, int* sEnd, int* sCm,
                               int* sSeed = nullptr, int stride = 0,
                               int rate = 1) {
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
    int e = -1;
    sEnd[0] = 0;
    for (int s = R.k - 1; s >= 1; --s) {
      e += sLen[s];
      sEnd[s] = e;
    }
    if (sSeed) {
      int *seed0 = sSeed, *nseed = sSeed + R.k, *row0 = nseed + R.k;
      int i = 0, b = 0;
      for (int s = R.k - 1; s >= 1; --s) {
        seed0[s] = i;
        nseed[s] = seeds_in(sLen[s], stride, s == R.k - 1);
        i += nseed[s];
      }
      for (int s = 1; s < R.k; ++s) {
        row0[s] = b;
        b += (sLen[s] + rate - 1) / rate;
      }
      seed0[0] = nseed[0] = row0[0] = 0;
    }
  }
  __syncthreads();
  return cm_in_smem ? sCm : R.c_mat;
}

// This lane's segment: its C row, rows, and the walk constants.
struct Lane {
  const int* C;
  int row, last, nb, len, base;
  bool active, anchor;
};

// One step of N walks of the group's lane states X (on: group-uniform);
// between() runs once the step's loads are issued.
template <int BITS, int N, typename F>
__device__ __forceinline__ void lane_step(const Rows& S, const Lane& me,
                                          unsigned gmask, int G, int c,
                                          int (&X)[N], const bool (&on)[N],
                                          F&& between) {
  int row[N], cut[N], tot[N], occ[N], corr[N];
  bool live[N];
  const int totc = BITS || !me.active ? 0 : total_of(me.C, S.sigma, me.len, c);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    locate(S, X[e], me.nb, row[e], cut[e]);
    tot[e] = row[e] == me.nb - 1 ? totc : -1;
    row[e] += me.base;
    live[e] = on[e] && me.active;
  }
  ranks<BITS, N>(S, row, live, c, cut, tot, occ, [&] {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      // wrap corrections from the pre-update states: the lane after this
      // one (the anchor lane: nothing, which sorts first)
      const int cmp = me.row < X[e];
      int nxt = __shfl_down_sync(gmask, cmp, 1, G);
      if (me.anchor) nxt = 1;
      corr[e] = me.last == c ? nxt - cmp : 0;
    }
    between();
  });
  const int Cc = me.active ? me.C[c] : 0;
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (on[e]) X[e] = me.active ? Cc + occ[e] + corr[e] : 0;
}

__device__ __forceinline__ int group_sum(int v, unsigned gmask, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(gmask, v, o, G);
  return v;
}

// Seed i: (step, window end, segment, q) from the shared seed tables.
__device__ __forceinline__ int4 seed_of(int i, int k, int stride,
                                        const int* sSeed, const int* sEnd) {
  const int *seed0 = sSeed, *nseed = sSeed + k;
  int s = k - 1;
  while (i >= seed0[s] + nseed[s]) --s;
  const int q = nseed[s] - (i - seed0[s]);
  const int t = sEnd[s] - q * stride;
  return make_int4(t, t + stride, s, q);
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    kway_chain_kernel(Rows S, Run R, const int2* __restrict__ clf,
                      Seeding Sd, int rate, int* __restrict__ meets,
                      int* __restrict__ ins) {
  extern __shared__ int smem[];
  const int k = R.k, G = R.G, n_seeds = Sd.n;
  int *sLen = smem, *sLast = sLen + k, *sOff = sLast + k, *sEnd = sOff + k,
      *sSeed = sEnd + k, *sCm = sSeed + 3 * k;
  const int* Cm = load_run(R, S.sigma, sLen, sLast, sOff, sEnd, sCm, sSeed,
                           Sd.stride, rate);
  const int chain = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (chain > n_seeds) return;           // whole groups
  const int lane = threadIdx.x & (G - 1);
  const unsigned gmask =
      G == 32 ? FULL : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  Lane me;
  me.active = lane < k;
  me.anchor = lane == k - 1;
  me.row = me.active ? R.row[lane] : 0;
  me.last = me.active ? sLast[lane] : 0;
  me.nb = me.active ? R.nb[lane] : 1;
  me.len = me.active ? sLen[lane] : 0;
  me.base = (me.active ? lane : 0) * R.NB;
  me.C = Cm + (size_t)(me.active ? lane : 0) * S.sigma;
  const int last_step = sEnd[1];
  auto nothing = [] {};

  int t, seg, rr, I;
  int2 pair;
  if (chain == 0) {
    // anchor: U's length-1 suffix sorts before every longer suffix sharing
    // its first character, in every segment's order at once
    t = 0;
    seg = k - 1;
    rr = Cm[(size_t)seg * S.sigma + sLast[seg]];
    I = me.active ? me.C[sLast[seg]] : 0;
    pair = __ldg(clf + sOff[seg] + rr);
  } else {
    const int4 sd = seed_of(chain - 1, k, Sd.stride, sSeed, sEnd);
    t = sd.x;
    seg = sd.z;
    rr = __ldg(Sd.rows + sSeed[2 * k + seg] + sd.w * Sd.per);
    pair = __ldg(clf + sOff[seg] + rr);
    int X[2] = {lane == seg ? rr : 0, lane == seg ? rr : me.len};
    const bool both[2] = {true, true};
    bool met = false;
    while (t < sd.y) {                   // never past the segment's end
      const int2 ahead = __ldg(clf + sOff[seg] + pair.y);
      lane_step<BITS, 2>(S, me, gmask, G, pair.x, X, both, nothing);
      rr = pair.y;
      pair = ahead;
      ++t;
      if (lane == seg) X[0] = X[1] = rr;  // the walked lane is exact
      if (__all_sync(gmask, X[0] == X[1])) {
        met = true;
        break;
      }
    }
    if (meets && lane == 0) meets[chain - 1] = met ? t : -1;
    if (!met) return;
    I = X[0];
  }
  // the exact chain from step t, the following seeds' bounds alongside
  int j = chain;
  int4 nxt = j < n_seeds ? seed_of(j, k, Sd.stride, sSeed, sEnd)
                         : make_int4(INT_MAX, 0, 0, 0);
  int X[3] = {I, 0, 0};
  bool bounds = false;                   // a seed's bounds under way
  const bool all[3] = {true, true, true}, one[1] = {true};
  for (;;) {
    if (!bounds && t == nxt.x) {
      bounds = true;
      X[1] = lane == seg ? rr : 0;
      X[2] = lane == seg ? rr : me.len;
    }
    if (t == last_step) {
      const int total = group_sum(X[0], gmask, G);
      if (lane == seg) ins[sOff[seg] + X[0]] = total - X[0];
      break;
    }
    // the symbol to prepend: the walked segment's BWT at its own row, or
    // at a boundary the previous segment's last character
    const bool boundary = t == sEnd[seg];
    int c, nx;
    if (boundary) {
      c = sLast[seg - 1];
      nx = Cm[(size_t)(seg - 1) * S.sigma + c];
    } else {
      c = pair.x;
      nx = pair.y;
    }
    const int2 ahead = __ldg(clf + sOff[seg - boundary] + nx);
    const int seg_now = seg, I_now = X[0];
    auto record = [&] {
      const int total = group_sum(I_now, gmask, G);
      if (lane == seg_now) ins[sOff[seg_now] + I_now] = total - I_now;
    };
    if (bounds) {                        // the exact walk and both bounds
      lane_step<BITS, 3>(S, me, gmask, G, c, X, all, record);
    } else {                             // the exact walk alone
      int X1[1] = {X[0]};
      lane_step<BITS, 1>(S, me, gmask, G, c, X1, one, record);
      X[0] = X1[0];
    }
    seg -= boundary;
    rr = nx;
    pair = ahead;
    ++t;
    if (bounds) {                        // never across a boundary
      if (lane == seg) X[1] = X[2] = rr;
      if (__all_sync(gmask, X[1] == X[2])) break;  // that seed records t on
      if (t == nxt.y) {                  // it failed: walk on through it
        bounds = false;
        ++j;
        nxt = j < n_seeds ? seed_of(j, k, Sd.stride, sSeed, sEnd)
                          : make_int4(INT_MAX, 0, 0, 0);
      }
    }
  }
}

// k > 32: the warps of one block walk one chain, each thread taking lanes
// tid, tid + T, ...; the states double-buffered in shared memory, the
// per-warp partial sums too, so a step needs one barrier.
template <int BITS>
__global__ void kway_block_kernel(Rows S, Run R, const int2* __restrict__ clf,
                                  int* __restrict__ ins) {
  extern __shared__ int smem[];
  const int k = R.k, T = blockDim.x, tid = threadIdx.x;
  int *sI0 = smem, *sI1 = sI0 + k, *sRow = sI1 + k, *sNb = sRow + k,
      *sPart = sNb + k, *sLen = sPart + 64, *sLast = sLen + k,
      *sOff = sLast + k, *sEnd = sOff + k, *sCm = sEnd + k;
  for (int i = tid; i < k; i += T) {
    sRow[i] = R.row[i];
    sNb[i] = R.nb[i];
  }
  const int* Cm = load_run(R, S.sigma, sLen, sLast, sOff, sEnd, sCm);
  const int warp = tid >> 5, lane32 = tid & 31, n_warps = (T + 31) >> 5;
  const int last_step = sEnd[1];

  int seg = k - 1;
  int rr = Cm[(size_t)seg * S.sigma + sLast[seg]];
  int2 pair = __ldg(clf + sOff[seg] + rr);
  int part = 0;
  for (int l = tid; l < k; l += T) {
    sI0[l] = Cm[(size_t)l * S.sigma + sLast[seg]];
    part += sI0[l];
  }
  part = group_sum(part, FULL, 32);
  if (lane32 == 0) sPart[warp] = part;
  __syncthreads();
  if (tid == seg % T) {
    int total = 0;
    for (int w = 0; w < n_warps; ++w) total += sPart[w];
    ins[sOff[seg] + sI0[seg]] = total - sI0[seg];
  }

  int *cur = sI0, *nxt_buf = sI1;
  for (int t = 0; t < last_step; ++t) {
    const bool boundary = t == sEnd[seg];
    int c, nx;
    if (boundary) {
      c = sLast[seg - 1];
      nx = Cm[(size_t)(seg - 1) * S.sigma + c];
    } else {
      c = pair.x;
      nx = pair.y;
    }
    const int2 ahead = __ldg(clf + sOff[seg - boundary] + nx);
    int* part_buf = sPart + 32 * ((t + 1) & 1);
    part = 0;
    for (int l = tid; l < k; l += T) {
      const int I = cur[l];
      const int cmp = sRow[l] < I;
      const int nxt = l == k - 1 ? 1 : (int)(sRow[l + 1] < cur[l + 1]);
      const int corr = sLast[l] == c ? nxt - cmp : 0;
      int row[1], cut[1], occ[1];
      locate(S, I, sNb[l], row[0], cut[0]);
      const int tot[1] = {BITS || row[0] < sNb[l] - 1
                              ? -1
                              : total_of(Cm + (size_t)l * S.sigma, S.sigma,
                                         sLen[l], c)};
      row[0] += l * R.NB;
      const bool live[1] = {true};
      ranks<BITS, 1>(S, row, live, c, cut, tot, occ, [] {});
      const int I_new = Cm[(size_t)l * S.sigma + c] + occ[0] + corr;
      nxt_buf[l] = I_new;
      part += I_new;
    }
    part = group_sum(part, FULL, 32);
    if (lane32 == 0) part_buf[warp] = part;
    __syncthreads();
    seg -= boundary;
    rr = nx;
    pair = ahead;
    if (tid == seg % T) {
      int total = 0;
      for (int w = 0; w < n_warps; ++w) total += part_buf[w];
      ins[sOff[seg] + nxt_buf[seg]] = total - nxt_buf[seg];
    }
    int* sw = cur;
    cur = nxt_buf;
    nxt_buf = sw;
  }
}

static Rows make_rows(const void* fused, const void* blocks, const void* occ,
                      int wid, int sigma, int r) {
  int shift = -1;
  if (r > 0 && (r & (r - 1)) == 0)
    for (shift = 0; (1 << shift) < r; ++shift) {
    }
  const bool vec = (r & 3) == 0 && ((uintptr_t)blocks & 15) == 0;
  return Rows{(const uint32_t*)fused, (const int*)blocks, (const int*)occ,
              wid, sigma, r, shift, vec};
}

static int pow2_at_least(int k) {
  int p = 2;
  while (p < k) p *= 2;
  return p;
}

static size_t pairwise_smem(int sigma) {
  return (size_t)sigma * sizeof(int) <= SMEM_C_MAX ? sigma * sizeof(int) : 0;
}

static size_t kway_smem(int k, int sigma, bool block) {
  const size_t cm = (size_t)k * sigma * sizeof(int);
  const size_t cm_smem = cm <= SMEM_C_MAX ? cm : 0;
  return (block ? (8 * (size_t)k + 64) : 7 * (size_t)k) * sizeof(int) +
         cm_smem;
}

template <typename K>
static const void* by_bits(int bits, K k2, K k4, K k0) {
  return bits == 2 ? (const void*)k2 : bits == 4 ? (const void*)k4
                                                 : (const void*)k0;
}

extern "C" int merge_walk_launch(const void* fusedA, const void* blocksA,
                                 const void* occA, int wid, int nbA,
                                 int sigma, int bits, int r, const void* cA,
                                 const void* cB, const void* clf, int nB,
                                 const void* ends, const void* seed_rows,
                                 int rate, int stride, int n_seeds,
                                 void* meets, void* ins, void* stream) {
  if (nB > 0) {
    const Rows A = make_rows(fusedA, blocksA, occA, wid, sigma, r);
    const Seeding Sd{(const int*)seed_rows, stride,
                     stride > 0 ? stride / rate : 0, n_seeds};
    const int grid = (n_seeds + 1 + THREADS - 1) / THREADS;
    const size_t smem = pairwise_smem(sigma);
    cudaStream_t st = (cudaStream_t)stream;
    const int* a = (const int*)cA;
    const int* b = (const int*)cB;
    const int2* p = (const int2*)clf;
    const int* e = (const int*)ends;
    if (bits == 2)
      pairwise_kernel<2><<<grid, THREADS, smem, st>>>(
          A, nbA, a, b, p, nB, e, Sd, (int*)meets, (int*)ins);
    else if (bits == 4)
      pairwise_kernel<4><<<grid, THREADS, smem, st>>>(
          A, nbA, a, b, p, nB, e, Sd, (int*)meets, (int*)ins);
    else
      pairwise_kernel<0><<<grid, THREADS, smem, st>>>(
          A, nbA, a, b, p, nB, e, Sd, (int*)meets, (int*)ins);
  }
  return (int)cudaGetLastError();
}

extern "C" int merge_walk_kway_launch(const void* fused, const void* blocks,
                                      const void* occ, int wid, int NB,
                                      int sigma, int bits, int r,
                                      const void* c_mat, const void* nb,
                                      const void* row, const void* last,
                                      const void* len, int k, const void* clf,
                                      const void* seed_rows, int rate,
                                      int stride, int n_seeds, void* meets,
                                      void* ins, void* stream) {
  if (k >= 2) {
    const Rows S = make_rows(fused, blocks, occ, wid, sigma, r);
    const bool block = k > 32;
    Run R{(const int*)c_mat, (const int*)nb, (const int*)row,
          (const int*)last, (const int*)len, k, NB,
          block ? 0 : pow2_at_least(k)};
    const size_t smem = kway_smem(k, sigma, block);
    cudaStream_t st = (cudaStream_t)stream;
    const int2* p = (const int2*)clf;
    if (!block) {
      const Seeding Sd{(const int*)seed_rows, stride,
                       stride > 0 ? stride / rate : 0, n_seeds};
      const int grid = (n_seeds + 1 + THREADS / R.G - 1) / (THREADS / R.G);
      if (bits == 2)
        kway_chain_kernel<2><<<grid, THREADS, smem, st>>>(
            S, R, p, Sd, rate, (int*)meets, (int*)ins);
      else if (bits == 4)
        kway_chain_kernel<4><<<grid, THREADS, smem, st>>>(
            S, R, p, Sd, rate, (int*)meets, (int*)ins);
      else
        kway_chain_kernel<0><<<grid, THREADS, smem, st>>>(
            S, R, p, Sd, rate, (int*)meets, (int*)ins);
    } else {
      const int threads = k < 1024 ? ((k + 31) / 32) * 32 : 1024;
      if (smem > 48 * 1024)
        cudaFuncSetAttribute(by_bits(bits, kway_block_kernel<2>,
                                     kway_block_kernel<4>,
                                     kway_block_kernel<0>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
      if (bits == 2)
        kway_block_kernel<2><<<1, threads, smem, st>>>(S, R, p, (int*)ins);
      else if (bits == 4)
        kway_block_kernel<4><<<1, threads, smem, st>>>(S, R, p, (int*)ins);
      else
        kway_block_kernel<0><<<1, threads, smem, st>>>(S, R, p, (int*)ins);
    }
  }
  return (int)cudaGetLastError();
}

// Registers, local (spilled) bytes and resident blocks of THREADS per SM of
// the chained kernel a walk launches (kway = 0: pairwise; else k-way over k
// <= 32 segments): out = {blocks_per_sm, registers, threads, local bytes}.
extern "C" int merge_walk_occupancy(int kway, int bits, int sigma, int k,
                                    int* out) {
  const void* fn =
      kway ? by_bits(bits, kway_chain_kernel<2>, kway_chain_kernel<4>,
                     kway_chain_kernel<0>)
           : by_bits(bits, pairwise_kernel<2>, pairwise_kernel<4>,
                     pairwise_kernel<0>);
  const size_t smem = kway ? kway_smem(k, sigma, false) : pairwise_smem(sigma);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = THREADS;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
