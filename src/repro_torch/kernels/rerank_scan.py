"""The paper's Re-rank step on sorted rank pairs: the head position of
each equal-pair group and the number of groups.  Plain PyTorch version +
CUDA kernel (``csrc/rerank_scan.cu``: one pass with a decoupled look-back,
one launch after one memset of its scratch).
"""

from __future__ import annotations

import torch

from . import _build, traffic

TILE = 4096      # pairs per tile of the kernel (WARPS * WARP_SPAN)
HEAD_INTS = 4    # scratch before the status words: counter, num_groups, pad


def rerank_scan_plain(r1: torch.Tensor, r2: torch.Tensor):
    """(ranks int32[n], num_groups int32 scalar tensor) for sorted pairs:
    ranks[i] = the largest j <= i with pair j != pair j-1 (j = 0 always
    counts).  One 1-D ``cumsum`` over the flags numbers the groups and a
    gather of the head positions maps each slot to its group's head
    (``torch.cummax`` computes the same but runs several times slower on
    the GPU)."""
    n = r1.shape[0]
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=r1.device),
                torch.zeros((), dtype=torch.int32, device=r1.device))
    flags = torch.ones(n, dtype=torch.bool, device=r1.device)
    flags[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
    group = torch.cumsum(flags, 0, dtype=torch.int32) - 1   # flags[0]: >= 0
    heads = torch.nonzero(flags).flatten().to(torch.int32)
    return heads[group.long()], (group[-1] + 1).to(torch.int32)


@traffic.reports("rerank_scan", traffic.rerank_scan_bytes)
def rerank_scan(r1: torch.Tensor, r2: torch.Tensor):
    """Re-rank of sorted int32 pairs; the plain version for CPU tensors,
    the CUDA kernel otherwise.  Equal pairs must be adjacent, as any sorted
    order makes them: the kernel finds the head of a group that starts
    before its tile by probing earlier pairs.  ``num_groups`` stays on the
    device: read it only where the caller needs it on the host."""
    if _build.on_cpu(r1, r2):
        return rerank_scan_plain(r1, r2)
    _build.check_cuda("rerank_scan", r1, r2)
    n = r1.shape[0]
    if r1.dim() != 1 or r2.shape != r1.shape:
        raise ValueError("rerank_scan: r1 and r2 must be 1-D of one length")
    if n >= 1 << 31:
        raise ValueError(f"rerank_scan: {n} pairs exceed int32 indexing")
    ranks = torch.empty(n, dtype=torch.int32, device=r1.device)
    if not n:
        return ranks, torch.zeros((), dtype=torch.int32, device=r1.device)
    # the tile counter, num_groups and one 64-bit status word per tile,
    # zeroed by the C entry; num_groups is returned as a view of it
    scratch = torch.empty(HEAD_INTS + 2 * (-(-n // TILE)), dtype=torch.int32,
                          device=r1.device)
    _build.launch("rerank_scan", r1.data_ptr(), r2.data_ptr(), n,
                  ranks.data_ptr(), scratch.data_ptr(), scratch.numel())
    return ranks, scratch[1]
