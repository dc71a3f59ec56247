"""Burrows-Wheeler transform from the suffix array, and its inverse.

bwt[i] = S[(SA[i] - 1) mod n]; the row ``I`` of the original string is the
position where SA[i] == 0 (paper §2.2).  The inverse transform (LF-mapping
walk) is a validation oracle: the BWT must be reversible.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .suffix_array import suffix_array


def bwt_from_sa(s: torch.Tensor, sa: torch.Tensor):
    """(bwt int32[n], I int32 scalar): last column of the sorted rotation
    matrix + original row."""
    n = s.shape[0]
    prev = torch.remainder(sa.to(torch.int64) - 1, n)
    bwt = s[prev]
    row = torch.argmin(sa).to(torch.int32)  # position where sa == 0
    return bwt, row


def bwt(s: torch.Tensor, sigma: int):
    """End-to-end single-device BWT (the reference path: the seed
    prefix-doubling SA, then the join)."""
    return bwt_from_sa(s, suffix_array(s, sigma))


def lf_mapping(bwt_arr: torch.Tensor, sigma: int) -> torch.Tensor:
    """LF[i] = C[bwt[i]] + occ(bwt[i], i): O(n * sigma) memory, a test
    oracle."""
    counts = kernel_ops.char_histogram(bwt_arr, sigma)
    c_array = torch.cumsum(counts, 0) - counts
    onehot = (bwt_arr[:, None] == torch.arange(sigma, device=bwt_arr.device))
    occ_incl = torch.cumsum(onehot.to(torch.int64), 0)
    rank = occ_incl.gather(1, bwt_arr.long()[:, None])[:, 0] - 1
    return (c_array[bwt_arr] + rank).to(torch.int32)


def inverse_bwt(bwt_arr: torch.Tensor, row, sigma: int) -> torch.Tensor:
    """Reconstruct the original string by walking the LF mapping backwards
    from the row of the original rotation (host loop; a test oracle)."""
    n = bwt_arr.shape[0]
    lf = lf_mapping(bwt_arr, sigma).tolist()
    b = bwt_arr.tolist()
    i = int(row)
    rev = []
    for _ in range(n):
        rev.append(b[i])
        i = lf[i]
    return torch.tensor(rev[::-1], dtype=torch.int32, device=bwt_arr.device)


def bwt_naive(s) -> tuple[np.ndarray, int]:
    """Rotation-sorting oracle (Figure 1 of the paper)."""
    s = np.asarray(s)
    n = len(s)
    rotations = sorted(range(n),
                       key=lambda i: np.concatenate([s[i:], s[:i]]).tolist())
    last = np.array([s[(i - 1) % n] for i in rotations], dtype=s.dtype)
    return last, rotations.index(0)
