"""The paper's competitor: Menon, Bhat & Schatz, "Rapid parallel genome
indexing with MapReduce" (MapReduce'11), as the JAX package's
``core/competitor.py`` reimplements it.

The suffix array is partitioned into ranges by a first sort over a K-char
prefix key, then each pass gathers the NEXT K characters of the suffixes
still tied and re-sorts within the tie groups (direct string comparison as
iterative K-char "prefix tupling").  Passes needed ~ LCP_max / K, against
ceil(log2 n) doubling rounds for the paper's algorithm.

The JAX package sorts the K + 1 keys with one ``lax.sort``; here each pass
is a chain of stable ``torch.sort`` passes, least significant key first,
which orders the same keys the same way.  The reference calls no Pallas
kernel here, so a plain sort is its counterpart on the card too.
"""

from __future__ import annotations

import torch

from .bwt import bwt_from_sa


def _lex_order(keys: list) -> torch.Tensor:
    """The permutation that sorts rows by ``keys`` (most significant
    first), stable: one stable sort per key, least significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def suffix_array_rpgi(s: torch.Tensor, *, prefix_block: int = 8,
                      max_passes: int = 4096) -> torch.Tensor:
    """Suffix array (int32[n]) via ranged direct-comparison sorting.

    ``s`` must be sentinel-terminated (token 0, unique, smallest).  Runs on
    the device of ``s``; each pass reads back one flag (all groups
    singletons) to end the loop."""
    n = s.shape[0]
    K = prefix_block
    dev = s.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    cols = torch.arange(K, dtype=torch.int64, device=dev)[None, :]

    def gather_block(order, t):
        """chars [t*K, (t+1)*K) of each suffix in ``order`` (-1 past end)."""
        pos = order[:, None].to(torch.int64) + t * K + cols
        chars = s[torch.clamp(pos, 0, n - 1)]
        return torch.where(pos < n, chars, -1)                 # (n, K)

    def regroup(group, keys):
        """group heads after sorting by (group, keys): adjacent compare."""
        same = group[1:] == group[:-1]
        for k in range(K):
            same &= keys[1:, k] == keys[:-1, k]
        flags = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           ~same])
        heads = torch.where(flags, idx, 0)
        return torch.cummax(heads, 0).values, bool(flags.all())

    # pass 0: range partitioning by the first K chars (splitter buckets)
    keys = gather_block(idx, 0)
    perm = _lex_order([keys[:, k] for k in range(K)])
    order = idx[perm]
    group, done = regroup(torch.zeros(n, dtype=torch.int32, device=dev),
                          keys[perm])
    t = 1
    while not done and t < max_passes:
        keys = gather_block(order, t)
        perm = _lex_order([group] + [keys[:, k] for k in range(K)])
        order = order[perm]
        group, done = regroup(group[perm], keys[perm])
        t += 1
    return order


def bwt_rpgi(s: torch.Tensor):
    """Competitor end to end: SA by ranged direct sort, then the BWT join.
    Returns (bwt, row) as ``bwt.bwt_from_sa``."""
    return bwt_from_sa(s, suffix_array_rpgi(s))
