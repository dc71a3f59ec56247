"""Distributed prefix-doubling suffix array + BWT (the paper's
contribution), over a ``torch.distributed`` mesh: every rank runs these
functions on its shard of the text, and the collectives of
``core.dist_sort`` join them.

    Init       packed q-gram ranking: the first q characters of every
               suffix packed into 1-2 words (a (q-1)-character halo from
               the next rank), one distributed sort and a re-rank; or the
               seed histogram init (``dist_initial_ranks``, ``qgram=False``)
    Shift      ``shift_sharded`` (two static ppermutes)
    Pair+Sort  each (rank, rank[i+h]) pair packs into one or two key words
               (``core.keypack``); engine "bitonic" (deterministic) or
               "samplesort" (the paper's range shuffle); local sorts
               through the radix kernels or the compare sort
    Re-rank    grouped form: new_rank = rank + (pair-run head - rank-run
               head), with boundary halos, a local prefix max and a
               distributed exclusive max
    Discard    a suffix whose rank is unique never re-sorts: its key
               becomes a pad, and samplesort's all_to_all skips pad slots
    Scatter    new ranks + active flags back to index order
    Iterate    h <- q, 2q, 4q, ...; a round runs while any suffix is
               active anywhere (one host read of the psum'd flag a round)

``build_isa_sharded`` / ``build_bwt_sharded`` are the entry points; they
take the whole prepared text on every rank and return this rank's shards.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from . import keypack
from ..devices import resolve_device
from ..kernels import ops as kernel_ops
from ..kernels._bits import i32
from .dist_sort import (
    AXIS,
    ShardInfo,
    _me,
    all_gather,
    as_word,
    bitonic_sort_sharded,
    exclusive_max_sharded,
    ppermute,
    psum,
    samplesort_sharded,
    scatter_to_index_bitonic,
    scatter_to_index_samplesort,
    shard_info,
    shift_sharded,
)
from .suffix_array import OVERFLOW_RANK, resolve_local_sort

BITONIC = "bitonic"
SAMPLESORT = "samplesort"
OVERFLOWED = -2   # every rank of an ISA whose samplesort overflowed


class DistSAConfig(NamedTuple):
    """The JAX package's ``DistSAConfig``: the mesh build's knobs, in the
    reference's order and with its defaults (a saved catalog records them,
    so catalogs are the same bytes in both packages).  The single-device
    build reads the last four."""

    axis: str = AXIS
    engine: str = BITONIC
    capacity_factor: float = 2.0   # samplesort bucket slack (skew knob)
    rounds: int | None = None      # default ceil(log2 (n / h0))
    qgram: bool = True             # packed q-gram init (False: Occ init)
    qgram_words: int = 2           # 32-bit words per init key
    discard: bool = True           # drop unique-rank suffixes from the loop
    local_sort: str = "auto"       # "compare" | "radix" | "auto"


def _gidx(info: ShardInfo, device) -> torch.Tensor:
    return _me(info) * info.part_size + torch.arange(
        info.part_size, dtype=torch.int32, device=device)


def dist_initial_ranks(info: ShardInfo, s_local: torch.Tensor, sigma: int):
    """Seed Init: global char histogram (psum of the local histograms),
    exclusive cumsum = Occ, local lookup; plus the active flags (the char
    occurs more than once)."""
    counts = psum(info, kernel_ops.char_histogram(s_local, sigma))
    occ = torch.cumsum(counts, 0) - counts
    idx = s_local.long()
    return occ[idx].to(torch.int32), counts[idx] > 1


def _last_head(heads: torch.Tensor) -> torch.Tensor:
    """Local index of the last True of ``heads`` at or before each slot
    (-1 before the first): one 1-D cumsum, a scatter of the heads'
    positions in order, and a gather."""
    n = heads.shape[0]
    seen = torch.cumsum(heads, 0, dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=heads.device)
    at = torch.empty(n + 1, dtype=torch.int32, device=heads.device)
    # non-heads all write slot n, which is never read
    at.scatter_(0, torch.where(heads, seen - 1, n).long(), pos)
    last = at[torch.clamp(seen - 1, min=0).long()]
    return torch.where(seen > 0, last, -1)


def dist_rerank(info: ShardInfo, cols, n_valid, *, grouped: bool = False,
                want_active: bool = False):
    """The paper's Re-Ranking on the globally sorted (active) sequence.

    ``cols`` are sorted column arrays whose valid slots form a prefix of
    each local shard; the global position of local valid slot p is (valid
    slots on earlier ranks) + p.  Group heads look one slot back across
    the boundary (the last valid tuple of the previous non-empty rank).

    * ``grouped=False``: rank = global head position of the equal group.
    * ``grouped=True`` (``cols = (rank, rank2)``): rank = cols[0] +
      (pair-run head pos - rank-run head pos), the head position the full
      re-rank assigns, from the active suffixes alone.
    * ``want_active``: also "my pair group has size >= 2" flags (the
      successor halo is the first valid tuple of the next non-empty rank).

    Returns ``(ranks, active)``; ``active`` is None unless requested.  Two
    all_gathers: the halos with the valid counts, then the head carries.
    """
    cols = tuple(cols)
    K = len(cols)
    slots = cols[0].shape[0]
    dev = cols[0].device
    pos = torch.arange(slots, dtype=torch.int32, device=dev)
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
    valid = pos < n_valid
    last = torch.clamp(n_valid - 1, min=0).long()
    halo = torch.cat([n_valid.reshape(1)]
                     + [c[last].reshape(1).to(torch.int32) for c in cols]
                     + [c[:1].to(torch.int32) for c in cols])
    g = all_gather(info, halo)                         # (P, 1 + 2K)
    g_valid, g_last, g_first = g[:, 0], g[:, 1: 1 + K], g[:, 1 + K:]
    me = _me(info)
    offset = g_valid[:me].sum(dtype=torch.int32)
    g_has = g_valid > 0
    jidx = torch.arange(info.parts, device=dev)
    prev_mask = (jidx < me) & g_has
    prev_exists = prev_mask.any()
    prev_k = g_last[torch.argmax(torch.where(prev_mask, jidx, -1))]

    neq0 = None
    neq_pair = torch.zeros(slots, dtype=torch.bool, device=dev)
    for i, c in enumerate(cols):
        prev = torch.cat([prev_k[i: i + 1].to(c.dtype), c[:-1]])
        ne = c != prev
        neq0 = ne if neq0 is None else neq0
        neq_pair = neq_pair | ne
    # the first global element has no predecessor: always a group head
    neq0 = neq0.clone()
    neq0[0] |= ~prev_exists
    neq_pair[0] |= ~prev_exists

    pair_head = valid & neq_pair
    heads = [pair_head] + ([valid & neq0] if grouped else [])
    local = [torch.where(lh >= 0, offset + lh, -1)
             for lh in map(_last_head, heads)]
    carry = exclusive_max_sharded(info, torch.stack([x[-1] for x in local]))
    pair_pos, *col0 = [torch.maximum(x, c) for x, c in zip(local, carry)]
    if grouped:
        ranks = (cols[0].to(torch.int32) + (pair_pos - col0[0])).to(
            torch.int32)
    else:
        ranks = pair_pos.to(torch.int32)
    if not want_active:
        return ranks, None

    next_mask = (jidx > me) & g_has
    next_k = g_first[torch.argmax(next_mask.to(torch.int32))]  # first True
    total = g_valid.sum(dtype=torch.int32)
    in_shard = pos + 1 < n_valid
    neq_succ = torch.zeros(slots, dtype=torch.bool, device=dev)
    for i, c in enumerate(cols):
        succ = torch.where(in_shard, torch.roll(c, -1), next_k[i].to(c.dtype))
        neq_succ = neq_succ | (c != succ)
    is_glast = offset + pos == total - 1               # no successor at all
    active = valid & ~(pair_head & (neq_succ | is_glast))
    return ranks, active


def dist_qgram_init(info: ShardInfo, cfg: DistSAConfig, eng: str,
                    s_local: torch.Tensor, sigma: int):
    """Packed q-gram init: rank every suffix by its first q characters in
    one distributed sort.  Returns (rank, active, q, overflow)."""
    q, fpw, bits = keypack.qgram_params(sigma, cfg.qgram_words)
    P, m = info.parts, info.part_size
    dev = s_local.device
    if q - 1 <= m:
        # all q windows are local given a (q-1)-char halo from the next
        # rank: ONE small ppermute instead of q-1 full-shard shifts
        if q > 1:
            halo = ppermute(info, s_local[: q - 1],
                            [(i, (i - 1) % P) for i in range(P)])
            if _me(info) == P - 1:   # past the global end: the sentinel 0
                halo = torch.zeros_like(halo)
            ext = torch.cat([s_local, halo])
        else:
            ext = s_local
        chars = [ext[j: j + m] for j in range(q)]
    else:
        # tiny shards (m < q - 1): iterated distributed shifts
        chars = [s_local]
        for _ in range(q - 1):
            chars.append(shift_sharded(info, chars[-1], 1, 0))
    nw = cfg.qgram_words
    words = []
    for w in range(nw):
        v = torch.zeros(m, dtype=torch.int64, device=dev)
        for j in range(w * fpw, (w + 1) * fpw):
            v = (v << bits) | chars[j]
        words.append(i32(v))
    del chars
    gidx = _gidx(info, dev)
    kb = (min(32, fpw * bits),) * nw

    if cfg.engine == BITONIC:
        sorted_ops = bitonic_sort_sharded(
            info, (*words, gidx), num_keys=nw, local_sort=eng, key_bits=kb)
        ranks_s, active_s = dist_rerank(info, sorted_ops[:nw], m,
                                        grouped=False, want_active=True)
        rank, act = scatter_to_index_bitonic(
            info, sorted_ops[nw], (ranks_s, active_s.to(torch.int32)),
            local_sort=eng)
        return rank, act.bool(), q, torch.tensor(False, device=dev)

    pads = (keypack.qgram_pad(fpw, bits),) * nw
    res = samplesort_sharded(
        info, (*words, gidx), num_keys=nw,
        capacity_factor=cfg.capacity_factor, key_pads=pads,
        local_sort=eng, key_bits=kb)
    del words
    ranks_s, active_s = dist_rerank(info, res.operands[:nw], res.n_valid,
                                    grouped=False, want_active=True)
    gidx_s, n_valid, bad = res.operands[nw], res.n_valid, res.overflow
    del res
    valid = torch.arange(gidx_s.shape[0], device=dev) < n_valid
    (rank, act), ovf = scatter_to_index_samplesort(
        info, gidx_s, (ranks_s, active_s.to(torch.int32)), valid=valid,
        capacity_factor=cfg.capacity_factor)
    bad = bad | ovf
    rank = torch.where(bad, OVERFLOWED, rank)
    return rank, act.bool(), q, bad


def _doubling_round(info: ShardInfo, cfg: DistSAConfig, eng: str,
                    spec: keypack.PairSpec, h: int, rank, gidx, active):
    """One fused-key prefix-doubling round over the active suffixes;
    returns (new_rank, new_active, done, suffixes still active
    anywhere)."""
    m = info.part_size
    dev = rank.device
    r2 = shift_sharded(info, rank, h, OVERFLOW_RANK)
    words = keypack.pack_pairs(rank, r2, spec)
    del r2
    pads = spec.pad_words()
    kb = spec.key_bits
    W = spec.words
    if cfg.discard:
        # unique-rank suffixes become pad slots: they sort last and (with
        # samplesort) never enter the all_to_all
        words = tuple(torch.where(active, w, as_word(p))
                      for w, p in zip(words, pads))
    if cfg.engine == BITONIC:
        sorted_ops = bitonic_sort_sharded(
            info, (*words, gidx), num_keys=W, local_sort=eng, key_bits=kb)
        del words
        r1s, r2s = keypack.unpack_pairs(sorted_ops[:W], spec)
        idxs = sorted_ops[W]
        if cfg.discard:
            # pads sort after every real pair key, so the global active
            # prefix maps to per-rank valid prefixes
            n_act = psum(info, active.sum(dtype=torch.int32))
            n_valid = torch.clamp(n_act - _me(info) * m, 0, m).to(
                torch.int32)
        else:
            n_valid = m
        bad = torch.tensor(False, device=dev)
    else:
        n_valid_in = active.sum(dtype=torch.int32) if cfg.discard else None
        res = samplesort_sharded(
            info, (*words, gidx), num_keys=W,
            capacity_factor=cfg.capacity_factor, key_pads=pads,
            n_valid_in=n_valid_in, local_sort=eng, key_bits=kb)
        del words
        r1s, r2s = keypack.unpack_pairs(res.operands[:W], spec)
        idxs = res.operands[W]
        n_valid = res.n_valid
        bad = res.overflow
    ranks_s, active_s = dist_rerank(info, (r1s, r2s), n_valid,
                                    grouped=True, want_active=True)
    valid_s = torch.arange(r1s.shape[0], device=dev) < torch.as_tensor(
        n_valid, device=dev)
    vr = torch.where(valid_s, ranks_s, 0)
    va = torch.where(valid_s, 1 + active_s.to(torch.int32), 0)
    if cfg.engine == BITONIC:
        nr, na = scatter_to_index_bitonic(info, idxs, (vr, va),
                                          local_sort=eng)
    else:
        (nr, na), ovf = scatter_to_index_samplesort(
            info, idxs, (vr, va), valid=valid_s,
            capacity_factor=cfg.capacity_factor)
        bad = bad | ovf

    # na per index: 0 untouched (stays final), 1 became unique, 2 still
    # ambiguous
    new_rank = torch.where(na > 0, nr, rank)
    new_active = torch.where(na > 0, na == 2, active)
    # overflow poisons the result with a recognizable sentinel; the
    # pipeline checks ``isa_overflowed`` and retries with a larger factor
    new_rank = torch.where(bad, OVERFLOWED, new_rank)
    remaining = psum(info, new_active.sum(dtype=torch.int32))
    return new_rank, new_active, (remaining == 0) | bad, remaining


def num_rounds(n: int, h0: int = 1) -> int:
    """Doubling rounds to cover length n starting from pairing distance
    h0: smallest r with h0 * 2^r >= n."""
    if n <= max(1, h0):
        return 0
    return max(1, math.ceil(math.log2(n / h0)))


def dist_isa_local(info: ShardInfo, cfg: DistSAConfig, s_local: torch.Tensor,
                   sigma: int, *, stats: dict | None = None) -> torch.Tensor:
    """Local shard of S -> local shard of the ISA.  ``stats``, when given,
    receives the first pairing distance ``h0``, the suffixes still active
    anywhere after the init and after each round run (``remaining``: the
    round loop's one host read per round) and the seconds up to each of
    those reads (``init_s``, then ``round_s``)."""
    t0 = time.perf_counter()
    eng = resolve_local_sort(cfg.local_sort, s_local.device)
    if cfg.qgram and info.n > 1:
        rank, active, h0, bad = dist_qgram_init(info, cfg, eng, s_local,
                                                sigma)
    else:
        rank, active = dist_initial_ranks(info, s_local, sigma)
        h0, bad = 1, torch.tensor(False, device=s_local.device)
    gidx = _gidx(info, s_local.device)
    spec = keypack.pair_spec(info.n)
    remaining = psum(info, active.sum(dtype=torch.int32))
    done = (remaining == 0) | bad | (info.n <= 1)
    rounds = cfg.rounds if cfg.rounds is not None else num_rounds(info.n, h0)
    if stats is not None:
        stats.update(h0=h0, remaining=[int(remaining)],
                     init_s=time.perf_counter() - t0, round_s=[])
    for r in range(rounds):
        if bool(done):   # the same psum'd flag on every rank
            break
        t0 = time.perf_counter()
        rank, active, done, remaining = _doubling_round(
            info, cfg, eng, spec, h0 * 2 ** r, rank, gidx, active)
        if stats is not None:
            stats["remaining"].append(int(remaining))
            stats["round_s"].append(time.perf_counter() - t0)
    return rank


def dist_bwt_local(info: ShardInfo, cfg: DistSAConfig, s_local: torch.Tensor,
                   isa_local: torch.Tensor):
    """(S, ISA) local shards -> (SA, BWT, row): the paper's "join"
    bwt[i] = S[(SA[i]-1) mod n] as three routings, all permutations, so
    the bitonic engine is exact here:
      1. SA[isa[i]] = i           (scatter by rank)
      2. fetch c[i] = S[SA[i]-1]  (sort the queries to their owners)
      3. scatter the answers back by output position
    """
    eng = resolve_local_sort(cfg.local_sort, s_local.device)
    gidx = _gidx(info, s_local.device)
    n = info.n
    (sa_local,) = scatter_to_index_bitonic(info, isa_local, (gidx,),
                                           local_sort=eng)
    j = torch.remainder(sa_local - 1, n)
    kb = (max(1, n - 1).bit_length(),)
    j_sorted, outpos = bitonic_sort_sharded(info, (j, gidx), num_keys=1,
                                            local_sort=eng, key_bits=kb)
    del j
    # j is a permutation: after sorting, the local j's are exactly my range
    chars = s_local[(j_sorted - _me(info) * info.part_size).long()]
    (bwt_local,) = scatter_to_index_bitonic(info, outpos, (chars,),
                                            local_sort=eng)
    row = psum(info, torch.where(sa_local == 0, gidx, 0).sum(
        dtype=torch.int32))
    return sa_local, bwt_local, row


# ---------------------------------------------------------------------------
# entry points: the whole text on every rank in, this rank's shards out
# ---------------------------------------------------------------------------

def isa_overflowed(isa: torch.Tensor) -> bool:
    """True when a samplesort round overflowed its capacity bound (the
    flag is global: every rank's shard carries it)."""
    return bool((isa == OVERFLOWED).any())


def local_text(s, mesh, axis: str = AXIS, device=None):
    """(ShardInfo, this rank's shard of the prepared text ``s`` on
    ``device``).  ``len(s)`` must divide by the mesh's axis size."""
    info = shard_info(mesh, len(s), axis)
    lo = _me(info) * info.part_size
    shard = np.asarray(s, np.int32)[lo: lo + info.part_size]
    return info, torch.as_tensor(shard, device=resolve_device(device))


def build_isa_sharded(s, mesh, cfg: DistSAConfig = DistSAConfig(), *,
                      sigma: int, device=None, stats: dict | None = None):
    """This rank's shard of the distributed ISA of a sentinel-terminated
    token string (the whole text, host-side, on every rank), on
    ``device`` (None = the GPU)."""
    info, s_local = local_text(s, mesh, cfg.axis, device)
    return dist_isa_local(info, cfg, s_local, sigma, stats=stats)


def build_bwt_sharded(s, mesh, cfg: DistSAConfig = DistSAConfig(), *,
                      sigma: int, device=None):
    """This rank's (SA, BWT) shards and the replicated row of a
    sentinel-terminated token string."""
    info, s_local = local_text(s, mesh, cfg.axis, device)
    isa = dist_isa_local(info, cfg, s_local, sigma)
    return dist_bwt_local(info, cfg, s_local, isa)


def gather_shards(info: ShardInfo, x: torch.Tensor) -> torch.Tensor:
    """The global array of equal shards ``x``, on every rank."""
    return all_gather(info, x).reshape(-1, *x.shape[1:])
