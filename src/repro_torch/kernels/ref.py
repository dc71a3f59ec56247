"""Plain oracles for every kernel, written the slow, obvious way and
sharing no bit tricks with the plain versions beside the kernels (the
contract each kernel and plain version is asserted against)."""

from __future__ import annotations

import torch

from ._bits import u32


def char_histogram_ref(tokens: torch.Tensor, sigma: int) -> torch.Tensor:
    """Histogram of token values: int32[sigma] (a one-hot sum, so values
    outside [0, sigma) count nowhere)."""
    onehot = tokens.reshape(-1)[:, None] == torch.arange(
        sigma, device=tokens.device)
    return onehot.sum(dim=0).to(torch.int32)


def rerank_scan_ref(r1: torch.Tensor, r2: torch.Tensor):
    """Paper's Re-rank on a sorted pair sequence: (ranks int32[n],
    num_groups int32), rank = position of the head of each equal-group."""
    n = r1.shape[0]
    neq = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=r1.device), neq])
    heads = torch.where(flags, torch.arange(n, device=r1.device), -1)
    ranks = torch.cummax(heads, 0).values
    return ranks.to(torch.int32), flags.sum().to(torch.int32)


def radix_hist_ref(keys: torch.Tensor, shift: int, block: int) -> torch.Tensor:
    """Per-block 8-bit digit histograms: int32[n//block, 256]."""
    digits = ((u32(keys) >> shift) & 0xFF).reshape(-1, block)
    onehot = digits[..., None] == torch.arange(256, device=keys.device)
    return onehot.sum(dim=1).to(torch.int32)


def radix_sort_ref(operands, num_keys: int):
    """Stable-sort oracle: lexicographic over the key words read as
    unsigned, most-significant first, ties in input order."""
    n = operands[0].shape[0]
    keys = [u32(k).tolist() for k in operands[:num_keys]]
    order = sorted(range(n), key=lambda i: tuple(k[i] for k in keys))
    idx = torch.tensor(order, dtype=torch.long, device=operands[0].device)
    return tuple(a[idx] for a in operands)


def rank_select_ref(bwt_blocks, block_idx, c, cutoff) -> torch.Tensor:
    """Count of ``c[q]`` among the first ``cutoff[q]`` positions of block
    ``block_idx[q]``."""
    r = bwt_blocks.shape[1]
    blocks = bwt_blocks[block_idx.long()]
    pos = torch.arange(r, device=blocks.device)[None, :]
    return ((blocks == c[:, None]) & (pos < cutoff[:, None])).sum(dim=1).to(
        torch.int32)


def unpack_words(words: torch.Tensor, bits: int) -> torch.Tensor:
    """int32[..., W] packed words -> int32[..., W * (32//bits)] symbols
    (LSB-first field order: the inverse of ``rank_select.pack_words``)."""
    fpw = 32 // bits
    w = u32(words)[..., None]
    shifts = torch.arange(fpw, device=words.device) * bits
    fields = (w >> shifts) & ((1 << bits) - 1)
    return fields.reshape(*words.shape[:-1], -1).to(torch.int32)


def rank_packed_ref(fused, block_idx, c, cutoff, *, bits: int, sigma: int):
    """Oracle for the packed fused layout: unpack the selected block back to
    plain symbols and count (checkpoint base + scan)."""
    rows = fused[block_idx.long()]
    base = rows.gather(1, c.long()[:, None])[:, 0]
    syms = unpack_words(rows[:, sigma:], bits)
    pos = torch.arange(syms.shape[1], device=syms.device)[None, :]
    inblock = ((syms == c[:, None]) & (pos < cutoff[:, None])).sum(dim=1)
    return (base + inblock).to(torch.int32)
