"""FM-index rank queries: the packed fused-row rank (sigma <= 16) and the
unpacked in-block count (sigma > 16), each as a plain PyTorch version and a
hand-written CUDA kernel (``csrc/rank_packed.cu``, ``csrc/rank_select.cu``).

Layout (as in the JAX reference): the BWT is planed into 2-bit
(sigma <= 4) or 4-bit (sigma <= 16) fields packed LSB-first into 32-bit
words, and each checkpoint block is one fused row

    fused[b] = [ Occ checkpoint (sigma int32) | packed words (r/fpw int32) ]

``rank_packed`` / ``rank_select`` dispatch on the tensors' device: CPU
tensors take the plain version, CUDA tensors launch the kernel.
"""

from __future__ import annotations

import torch

from . import _build, traffic
from ._bits import i32, popcount32, u32

# LSB of every 2-bit / 4-bit field: replicating a symbol across fields is
# one multiply; a field equals the symbol iff its XOR-difference is zero.
_REP = {2: 0x55555555, 4: 0x11111111}


def packed_bits(sigma: int, sample_rate: int) -> int:
    """Field width for (sigma, block length r): 2, 4, or 0 (unpackable)."""
    for bits in (2, 4):
        if sigma <= (1 << bits) and sample_rate % (32 // bits) == 0:
            return bits
    return 0


def pack_words(symbols: torch.Tensor, bits: int) -> torch.Tensor:
    """int32[k*fpw] symbols in [0, 2^bits) -> int32[k] packed words.

    Negative entries (PAD tails) pack as 0; rank queries never reach them
    because in-block cutoffs are bounded by the true text length.  Built one
    field at a time, so the int64 transient is one word per output word.
    """
    fpw = 32 // bits
    v = symbols.clamp(min=0).view(-1, fpw)
    words = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    for j in range(fpw):
        words |= v[:, j].to(torch.int64) << (bits * j)
    return i32(words)


def _eq_fields(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-field zero test on XOR-ed words (int64 in [0, 2^32)): the LSB of
    each field is 1 iff the whole field is 0 (the symbols matched)."""
    rep = _REP[bits]
    t = x | (x >> 1)
    if bits == 4:
        t = t | (t >> 2)
    return (t & rep) ^ rep


def _cutoff_mask(word_iota: torch.Tensor, cutoff: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """int64 select mask keeping only the first ``cutoff`` fields of a block
    laid out over consecutive words (cutoff in [0, r])."""
    fpw = 32 // bits
    full = cutoff // fpw
    rem = (cutoff - full * fpw).to(torch.int64)
    partial = (torch.ones_like(rem) << (bits * rem)) - 1
    return torch.where(
        word_iota < full,
        torch.full_like(partial, 0xFFFFFFFF),
        torch.where(word_iota == full, partial, torch.zeros_like(partial)),
    )


def rank_packed_plain(fused, block_idx, c, cutoff, *, bits: int, sigma: int):
    """Popcount rank over the fused layout, in plain PyTorch.

    fused int32[nb, sigma + W]; block_idx/c/cutoff int32[B] -> int32[B]:
    Occ checkpoint + count of c in the first ``cutoff`` symbols of the
    selected block."""
    rows = fused[block_idx.long()]                           # (B, sigma+W)
    base = rows.gather(1, c.long()[:, None])[:, 0]
    w = u32(rows[:, sigma:])                                 # (B, W)
    eq = _eq_fields(w ^ (u32(c) * _REP[bits])[:, None], bits)
    wi = torch.arange(w.shape[1], device=w.device)[None, :]
    sel = _cutoff_mask(wi, cutoff[:, None], bits)
    cnt = popcount32(eq & sel).sum(dim=1)
    return (base.to(torch.int64) + cnt).to(torch.int32)


@traffic.reports("rank_packed", lambda fused, block_idx, c, cutoff, *, bits,
                 sigma: traffic.rank_packed_bytes(fused, block_idx, c, cutoff,
                                                  sigma, bits))
def rank_packed(fused, block_idx, c, cutoff, *, bits: int, sigma: int):
    """Occ(c_i, block_idx_i * r + cutoff_i) over the fused packed layout;
    the plain version for CPU tensors, the CUDA kernel otherwise."""
    if _build.on_cpu(fused, block_idx, c, cutoff):
        return rank_packed_plain(fused, block_idx, c, cutoff,
                                 bits=bits, sigma=sigma)
    _build.check_cuda("rank_packed", fused, block_idx, c, cutoff)
    if bits not in _REP or fused.dim() != 2 or fused.shape[1] <= sigma:
        raise ValueError(f"rank_packed: bad layout {tuple(fused.shape)}, "
                         f"bits={bits}, sigma={sigma}")
    B = block_idx.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=fused.device)
    if B:
        _build.launch("rank_packed", fused.data_ptr(), fused.shape[1], sigma,
                      bits, block_idx.data_ptr(), c.data_ptr(),
                      cutoff.data_ptr(), out.data_ptr(), B)
    return out


def rank_select_plain(bwt_blocks, block_idx, c, cutoff):
    """Count of ``c[q]`` among the first ``cutoff[q]`` symbols of block
    ``block_idx[q]``, in plain PyTorch: int32[nb, r] + int32[B] x 3 ->
    int32[B]."""
    r = bwt_blocks.shape[1]
    blocks = bwt_blocks[block_idx.long()]                    # (B, r)
    pos = torch.arange(r, device=blocks.device)[None, :]
    hit = (blocks == c[:, None]) & (pos < cutoff[:, None])
    return hit.sum(dim=1).to(torch.int32)


@traffic.reports("rank_select", lambda bwt_blocks, block_idx, c, cutoff:
                 traffic.rank_select_bytes(bwt_blocks, block_idx, cutoff))
def rank_select(bwt_blocks, block_idx, c, cutoff):
    """In-block counts over unpacked int32 blocks (checkpoint NOT
    included); the plain version for CPU tensors, the CUDA kernel
    otherwise."""
    if _build.on_cpu(bwt_blocks, block_idx, c, cutoff):
        return rank_select_plain(bwt_blocks, block_idx, c, cutoff)
    _build.check_cuda("rank_select", bwt_blocks, block_idx, c, cutoff)
    B = block_idx.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=bwt_blocks.device)
    if B:
        _build.launch("rank_select", bwt_blocks.data_ptr(),
                      bwt_blocks.shape[1], block_idx.data_ptr(), c.data_ptr(),
                      cutoff.data_ptr(), out.data_ptr(), B)
    return out
