"""Single-device suffix-array construction by prefix doubling.

``isa_prefix_doubling`` is the reference implementation of the paper's
algorithm (§2.2) and the bit-for-bit oracle for the fast path:

    Init      rank[i] = Occ(S(i))          (count of strictly-smaller chars)
    Pair      pair rank[i] with rank[i+h]  (overflow pairs with a value that
                                            compares below every real rank)
    Re-rank   sort pairs, new rank = position of the head of the equal-group
    Iterate   h <- 2h, until all ranks distinct (<= ceil(log2 n) rounds)

``build_isa_fast`` / ``suffix_array_fast`` are the production build engine
(same output), with the three optimisations of the JAX package's engine:
fused pair keys (``core.keypack``), a packed q-gram init that starts the
loop at h = q, and active-suffix discarding into geometrically shrinking
power-of-two capacity buckets (host-driven: one readback per round).

Local sorts dispatch through ``kernels.ops.local_sort``: the radix engine
(the CUDA hist/scatter kernels) or the stable compare sort; ``"auto"``
picks radix for CUDA tensors and compare for CPU tensors.  Ranks are
updated in place between rounds (nothing else holds them), which keeps one
int32 rank array alive instead of one per round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import keypack
from ..kernels import ops as kernel_ops
from ..kernels.ops import COMPARE, RADIX  # noqa: F401  (re-export)
from ..kernels.ops import resolve_sort_engine as resolve_local_sort

OVERFLOW_RANK = -1  # shorter suffix sorts first; real ranks are >= 0


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def initial_ranks(s: torch.Tensor, sigma: int) -> torch.Tensor:
    """Paper's Init step: rank[i] = Occ(S(i)) via histogram + exclusive
    cumulative sum."""
    counts = kernel_ops.char_histogram(s, sigma)
    occ = torch.cumsum(counts, 0) - counts
    return occ[s].to(torch.int32)


def rerank_from_sorted(r1_sorted: torch.Tensor, r2_sorted: torch.Tensor):
    """Paper's Re-rank step on lexicographically sorted pairs: new rank =
    position of the head of each equal-group.  Returns
    ``(new_ranks, all_distinct)``; the group count is the one host readback
    of a round."""
    ranks, groups = kernel_ops.rerank_scan(r1_sorted, r2_sorted)
    return ranks, int(groups) == r1_sorted.shape[0]


def shifted_ranks(rank: torch.Tensor, h: int) -> torch.Tensor:
    """rank2[i] = rank[i+h] for i+h < n else OVERFLOW_RANK."""
    n = rank.shape[0]
    out = torch.full_like(rank, OVERFLOW_RANK)
    if h < n:
        out[: n - h] = rank[h:]
    return out


def isa_prefix_doubling(s: torch.Tensor, sigma: int) -> torch.Tensor:
    """Inverse suffix array (suffix index -> rank) of sentinel-terminated
    ``s``: the seed algorithm, every round over all n suffixes."""
    n = s.shape[0]
    rank = initial_ranks(s, sigma)
    h, done = 1, n == 1
    while h < n and not done:
        r2 = shifted_ranks(rank, h)
        # signed lexicographic (rank, r2) order: stable sort by the minor
        # key, then by the major key (OVERFLOW_RANK = -1 sorts first)
        perm = torch.sort(r2, stable=True).indices
        perm = perm[torch.sort(rank[perm], stable=True).indices]
        new_sorted, done = rerank_from_sorted(rank[perm], r2[perm])
        rank = torch.empty_like(rank)
        rank[perm] = new_sorted
        h *= 2
    return rank


def sa_from_isa(isa: torch.Tensor) -> torch.Tensor:
    """SA[rank] = i  (inversion of a permutation)."""
    n = isa.shape[0]
    sa = torch.empty_like(isa)
    sa[isa.long()] = _arange(n, isa.device)
    return sa


def suffix_array(s: torch.Tensor, sigma: int) -> torch.Tensor:
    """Suffix array of a sentinel-terminated token string (seed builder)."""
    return sa_from_isa(isa_prefix_doubling(s, sigma))


# ---------------------------------------------------------------------------
# fast build engine: fused keys + packed q-gram init + discarding
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BuildStats:
    """Machine-readable build trajectory."""

    n: int
    sigma: int
    q: int                       # packed chars in the init key (1 = Occ init)
    h0: int                      # first pairing distance (q, or 1)
    rounds_executed: int = 0
    rounds_skipped: int = 0      # h=1.. doubling rounds the q-gram init skips
    active_frac: list = dataclasses.field(default_factory=list)
    local_sort: str = COMPARE
    discard: bool = True

    def as_dict(self):
        return dataclasses.asdict(self)


def _qgram_init(s, fpw: int, bits: int, words: int, engine: str):
    """Initial (rank, active) from the packed q-gram key of every suffix:
    one key sort + grouped re-rank instead of ceil(log2 q) doubling rounds.
    rank = head position of the key-equal group; active = group size > 1."""
    n = s.shape[0]
    keys = keypack.qgram_keys_local(s, fpw, bits, words)
    kb = (min(32, fpw * bits),) * words
    idx = _arange(n, s.device)
    sorted_ops = kernel_ops.local_sort((*keys, idx), words, engine=engine,
                                       key_bits=kb)
    ks, perm = sorted_ops[:words], sorted_ops[words].long()
    neq = torch.zeros(n - 1, dtype=torch.bool, device=s.device)
    for k in ks:
        neq |= k[1:] != k[:-1]
    one = torch.ones(1, dtype=torch.bool, device=s.device)
    head = torch.cat([one, neq])
    # re-rank by the whole key: the pair (k0, k1), or (k0, k0) for one
    # word; more words fold in from the first, since a slot's flag depends
    # only on whether its key differs from its predecessor's.  Each fold
    # keeps its pairs sorted (head positions rise with the key), which the
    # re-rank kernel needs
    ranks_sorted = ks[0]
    for k in ks[1:] or ks:
        ranks_sorted = kernel_ops.rerank_scan(ranks_sorted, k)[0]
    succ_head = torch.cat([head[1:], one])
    active_sorted = ~(head & succ_head)
    rank = torch.empty(n, dtype=torch.int32, device=s.device)
    rank[perm] = ranks_sorted
    active = torch.empty(n, dtype=torch.bool, device=s.device)
    active[perm] = active_sorted
    return rank, active


def _occ_init(s, sigma: int):
    """Seed Occ init + active flags (char occurs more than once)."""
    counts = kernel_ops.char_histogram(s, sigma)
    occ = torch.cumsum(counts, 0) - counts
    return occ[s].to(torch.int32), counts[s] > 1


def _fast_round(rank, active_idx, n_active: int, h: int, *, cap: int,
                engine: str):
    """One fused-key doubling round over the compacted active set; updates
    ``rank`` in place and returns ``(new_active int32[cap], n_still)``.

    Grouped re-rank: every rank is the global head position of its equal
    group, a size->=2 group is entirely active, and its active members are
    contiguous in the sorted active sequence, so
        new_rank = r1 + (pair_subrun_head_pos - r1_run_head_pos)
    equals the head position the full re-rank would assign.
    """
    n = rank.shape[0]
    dev = rank.device
    spec = keypack.pair_spec(n)
    W = spec.words
    slot = _arange(cap, dev)
    valid = slot < n_active
    ai = torch.where(valid, active_idx, 0)
    r1 = rank[ai.long()]
    tgt = ai + h
    r2 = torch.where(tgt < n, rank[tgt.clamp(max=n - 1).long()],
                     OVERFLOW_RANK)
    words = keypack.pack_pairs(r1, r2, spec)
    words = tuple(
        torch.where(valid, w, p - (1 << 32) if p >= (1 << 31) else p)
        for w, p in zip(words, spec.pad_words())
    )
    sorted_ops = kernel_ops.local_sort((*words, ai), W, engine=engine,
                                       key_bits=spec.key_bits)
    r1s, r2s = keypack.unpack_pairs(sorted_ops[:W], spec)
    ais = sorted_ops[W]

    # Pads sort strictly last (keypack proof), so the prefix of every valid
    # slot holds valid slots only: the unmasked head scans below equal the
    # reference's valid-masked scans on every slot that is read
    # (new_rank[valid_s]); pad slots get garbage that nothing reads.
    valid_s = slot < n_active
    one = torch.ones(1, dtype=torch.bool, device=dev)
    neq1 = torch.cat([one, r1s[1:] != r1s[:-1]])
    neq2 = torch.cat([one, r2s[1:] != r2s[:-1]])
    pair_head = valid_s & (neq1 | neq2)
    r1_pos = kernel_ops.rerank_scan(r1s, r1s)[0]
    pair_pos = kernel_ops.rerank_scan(r1s, r2s)[0]
    new_rank = r1s + (pair_pos - r1_pos)

    succ_head = torch.cat([pair_head[1:], ~one]) | (slot + 1 >= n_active)
    still = valid_s & ~(pair_head & succ_head)

    # the reference scatters with index n for invalid slots, dropped
    rank[ais[valid_s].long()] = new_rank[valid_s]
    keep = torch.nonzero(still).flatten()           # the per-round readback
    n_still = keep.shape[0]
    new_active = torch.full((cap,), n, dtype=torch.int32, device=dev)
    new_active[:n_still] = ais[keep]
    return new_active, n_still


def _cap_bucket(n_active: int, n: int, min_cap: int = 128) -> int:
    """Next power-of-two capacity (floored) for the compacted active set."""
    return min(n, max(min_cap, 1 << max(0, n_active - 1).bit_length()))


def build_isa_fast(
    s: torch.Tensor,
    sigma: int,
    *,
    local_sort: str = "auto",
    qgram: bool = True,
    qgram_words: int = 2,
    discard: bool = True,
):
    """ISA of a sentinel-terminated int32 token tensor via the fused-key
    engine, on the tensor's device.  Host-driven round loop (reads back the
    active count each round to pick the next capacity bucket); bit-for-bit
    identical to ``isa_prefix_doubling``.  Returns ``(isa, BuildStats)``."""
    n = s.shape[0]
    engine = resolve_local_sort(local_sort, s.device)
    if qgram and n > 1:
        q, fpw, bits = keypack.qgram_params(sigma, qgram_words)
        rank, active = _qgram_init(s, fpw, bits, qgram_words, engine)
        h = q
        skipped = keypack.qgram_rounds_skipped(q)
    else:
        q, h, skipped = 1, 1, 0
        rank, active = _occ_init(s, sigma)
    stats = BuildStats(n=n, sigma=sigma, q=q, h0=h, rounds_skipped=skipped,
                       local_sort=engine, discard=discard)
    if n <= 1:
        return rank, stats

    if discard:
        active_pos = torch.nonzero(active).flatten().to(torch.int32)
        n_active = active_pos.shape[0]
        cap = _cap_bucket(n_active, n)
        active_buf = torch.full((cap,), n, dtype=torch.int32, device=s.device)
        active_buf[:n_active] = active_pos
    else:
        n_active = n if bool(active.any()) else 0
        cap = n
        active_buf = _arange(n, s.device)

    while n_active > 0:
        if h >= 2 * n:
            raise RuntimeError("prefix doubling failed to converge "
                               "(bad sentinel?)")
        stats.active_frac.append(n_active / n)
        new_buf, remaining = _fast_round(rank, active_buf, n_active, h,
                                         cap=cap, engine=engine)
        stats.rounds_executed += 1
        h *= 2
        if discard:
            n_active = remaining
            new_cap = _cap_bucket(n_active, n)
            active_buf = new_buf[:new_cap] if new_cap < cap else new_buf
            cap = min(cap, new_cap)
        else:
            n_active = n if remaining else 0
    return rank, stats


def suffix_array_fast(s: torch.Tensor, sigma: int, **kwargs):
    """(SA, BuildStats) via the fused-key build engine."""
    isa, stats = build_isa_fast(s, sigma, **kwargs)
    return sa_from_isa(isa), stats


def suffix_array_naive(s) -> np.ndarray:
    """O(n^2 log n) numpy oracle for tests."""
    s = np.asarray(s)
    n = len(s)
    suffixes = sorted(range(n), key=lambda i: s[i:].tolist())
    return np.array(suffixes, dtype=np.int32)
