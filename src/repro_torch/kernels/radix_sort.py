"""Stable LSD radix sort over field-limited 32-bit key words (int32
storage read as uint32): the local-sort engine of the suffix-array build.

One 8-bit digit per pass, least-significant key word first, over tiles
of ``TILE`` consecutive keys (the JAX package's 1024-key ``block``, made
larger on the card; any tile in ``TILES`` gives the same result):

  1. ``radix_hist``            per-tile 256-bin digit histograms (kernel),
                               stored digit-major
  2. ``digit_major_bases``     exclusive scan in (digit, tile) order, in
                               place over that storage
  3. ``radix_scatter``         destination = bin base + stable intra-tile
                               rank, fused with the scatter of every
                               operand (kernel ``csrc/radix_pos.cu``: the
                               tile is ranked in shared memory, then each
                               operand is written in runs per digit)

Keys are field-limited: only ``key_bits[w]`` low bits of word ``w`` are
significant, so a k-bit key costs ``ceil(k/8)`` passes.  Every pass is
stable, hence so is the sort; pad slots appended after real data stay
behind equal real keys.

``radix_sort_plain`` is the plain counting sort, the twin of the JAX
package's ``radix_sort_jnp``; it is what ``ops.radix_sort`` runs for CPU
tensors.
"""

from __future__ import annotations

import torch

from . import _build, traffic
from ._bits import u32
from .radix_hist import TILE, _check_blocks, check_tile, radix_hist

MAX_OPS = 4  # operands one fused scatter pass moves (csrc/radix_pos.cu)


def digit_major_bases(hist: torch.Tensor) -> torch.Tensor:
    """(nblocks, 256) per-block histograms -> (nblocks, 256) global bin
    bases: exclusive scan in (digit, block) order.  The result is the
    transposed view of a digit-major (256, nblocks) tensor; when ``hist``
    is already such a view (``radix_hist``'s kernel output) no transpose
    is copied."""
    nblocks, nbins = hist.shape
    flat = hist.t().reshape(-1)                    # digit-major
    starts = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    return starts.view(nbins, nblocks).t()


def radix_pos_plain(keys, base, shift: int, *, block: int = 1024):
    """Destination of every key for one 8-bit pass, in plain PyTorch:
    ``base[blk, digit]`` + the key's stable rank among its block's keys of
    the same digit (from one stable sort over ``blk * 256 + digit``)."""
    n = keys.shape[0]
    _check_blocks(n, block)
    dev = keys.device
    blk = torch.arange(n, device=dev) // block
    group = blk * 256 + ((u32(keys) >> shift) & 0xFF)
    order = torch.sort(group, stable=True).indices
    sorted_at = torch.empty_like(order)
    sorted_at[order] = torch.arange(n, device=dev)
    hist = torch.bincount(group, minlength=(n // block) * 256).view(-1, 256)
    below = (torch.cumsum(hist, 1) - hist).view(-1)   # smaller digits in blk
    intra = sorted_at - (blk * block + below[group])
    return (base.reshape(-1)[group].to(torch.int64) + intra).to(torch.int32)


def _launch_pos(keys, base, shift, block, pos_out, operands, outs):
    _build.check_cuda("radix_pos", keys, *operands, *outs)
    # the bases are read through their strides: a digit-major view
    # (digit_major_bases) and a contiguous tile-major table both work
    if base.device != keys.device or base.dtype != torch.int32:
        raise ValueError("radix_pos: base must be int32 on the keys' device")
    n = keys.shape[0]
    check_tile("radix_pos", n, block)
    if len(operands) > MAX_OPS or len(outs) != len(operands):
        raise ValueError(f"radix_pos: at most {MAX_OPS} operands, each with "
                         "an output")
    if base.shape != (n // block, 256):
        raise ValueError(f"radix_pos: base shape {tuple(base.shape)}")
    for t in (*operands, *outs):
        if t.shape[0] != n:
            raise ValueError("radix_pos: operands must match the keys")
    ins = [t.data_ptr() for t in operands] + [None] * (MAX_OPS - len(operands))
    ots = [t.data_ptr() for t in outs] + [None] * (MAX_OPS - len(outs))
    if n:
        _build.launch("radix_pos", keys.data_ptr(), base.data_ptr(),
                      base.stride(0), base.stride(1), shift, n, block,
                      None if pos_out is None else pos_out.data_ptr(),
                      len(operands), *ins, *ots)


@traffic.reports("radix_pos", lambda keys, base, shift, *, block=1024:
                 traffic.radix_pass_bytes(keys, base, positions=True))
def radix_pos(keys, base, shift: int, *, block: int = 1024):
    """Destination of every key for one 8-bit pass (int32[n]); the plain
    version for CPU tensors, the CUDA kernel otherwise.  ``base`` holds
    int32 values of shape (n/block, 256) in any strides: the kernel reads
    the digit-major view that ``digit_major_bases`` returns in place."""
    if _build.on_cpu(keys, base):
        return radix_pos_plain(keys, base, shift, block=block)
    pos = torch.empty_like(keys)
    _launch_pos(keys, base, shift, block, pos, (), ())
    return pos


def radix_scatter_plain(keys, base, shift: int, operands, outs, *,
                        block: int = 1024) -> None:
    """One stable pass in plain PyTorch: positions, then one indexed write
    per operand."""
    pos = radix_pos_plain(keys, base, shift, block=block).long()
    for src, dst in zip(operands, outs):
        dst[pos] = src


@traffic.reports("radix_pos", lambda keys, base, shift, operands, outs, *,
                 block=1024: traffic.radix_pass_bytes(keys, base, operands))
def radix_scatter(keys, base, shift: int, operands, outs, *,
                  block: int = 1024) -> None:
    """One stable pass: ``outs[k][pos[i]] = operands[k][i]`` for every
    operand, with ``pos`` as in ``radix_pos``.  The CUDA kernel fuses the
    position and the scatter; CPU tensors take the plain version."""
    if _build.on_cpu(keys, base):
        radix_scatter_plain(keys, base, shift, operands, outs, block=block)
        return
    _launch_pos(keys, base, shift, block, None, tuple(operands), tuple(outs))


def _pad_value(bits: int) -> int:
    """Field-limited all-ones pad as an int32 bit pattern."""
    v = (1 << bits) - 1
    return v - (1 << 32) if v >= (1 << 31) else v


def radix_sort_blocked(operands, num_keys: int, key_bits, *,
                       block: int = TILE):
    """Stable LSD radix sort of key words (most-significant first) + int32
    payloads through the tile pipeline (hist -> bases -> fused scatter).
    ``block`` is the tile; every tile gives the same result.

    ``key_bits[w]`` bounds the significant bits of word ``w``; pads go
    after the real data and stay there because every pass is stable.  Two
    ping-pong buffer sets; the inputs are never written."""
    operands = tuple(operands)
    n = operands[0].shape[0]
    pad = (-n) % block
    if pad:
        operands = tuple(
            torch.cat([a, torch.full(
                (pad,), _pad_value(key_bits[i]) if i < num_keys else 0,
                dtype=a.dtype, device=a.device)])
            for i, a in enumerate(operands)
        )
    src, bufs = list(operands), [None, None]
    flip = 0
    for w in range(num_keys - 1, -1, -1):
        for shift in range(0, key_bits[w], 8):
            if bufs[flip] is None:
                bufs[flip] = [torch.empty_like(a) for a in operands]
            dst = bufs[flip]
            word = src[w]
            base = digit_major_bases(radix_hist(word, shift, block=block))
            radix_scatter(word, base, shift, src, dst, block=block)
            src, flip = dst, 1 - flip
    out = tuple(src)
    if pad:
        out = tuple(a[:n] for a in out)
    return out


def radix_sort_plain(operands, num_keys: int, key_bits):
    """Plain stable LSD counting sort (the twin of ``radix_sort_jnp``).

    The per-pass transient is an (n, 2^radix_bits) int32 cumsum; the digit
    narrows as n grows to keep it near 64 MiB (floor: 1-bit digits)."""
    n = operands[0].shape[0]
    radix_bits = max(1, min(8, 24 - max(1, n - 1).bit_length()))
    arrs = list(operands)
    for w in range(num_keys - 1, -1, -1):
        for shift in range(0, key_bits[w], radix_bits):
            nb = min(radix_bits, key_bits[w] - shift)
            nbins = 1 << nb
            d = (u32(arrs[w]) >> shift) & (nbins - 1)
            onehot = d[:, None] == torch.arange(nbins, device=d.device)
            incl = torch.cumsum(onehot.to(torch.int32), 0, dtype=torch.int32)
            totals = incl[-1]
            starts = torch.cumsum(totals, 0, dtype=torch.int32) - totals
            intra = incl.gather(1, d[:, None])[:, 0] - 1
            pos = (starts[d] + intra).long()
            new = []
            for a in arrs:
                out = torch.empty_like(a)
                out[pos] = a
                new.append(out)
            arrs = new
    return tuple(arrs)
