"""Per-tile 8-bit digit histograms: the counting pass of the LSD radix
local sort.  Plain PyTorch version + CUDA kernel (``csrc/radix_hist.cu``).

A tile (the JAX signature's ``block``) is the run of consecutive keys that
one histogram row counts and one CUDA block of the scatter pass sorts.  The
kernels take the tiles in ``TILES``; the sort engine uses ``TILE``.
"""

from __future__ import annotations

import torch

from . import _build, traffic
from ._bits import u32

TILE = 8192                 # the sort engine's tile on the card
TILES = (1024, TILE)        # what csrc/radix_{hist,pos}.cu take: the JAX
                            # signature's block and the engine's tile


def _check_blocks(n: int, block: int) -> None:
    if block <= 0 or n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")


def check_tile(name: str, n: int, block: int) -> None:
    """Raise unless the CUDA kernels can take ``block`` for n keys."""
    _check_blocks(n, block)
    if block not in TILES:
        raise ValueError(f"{name}: block={block} is not one of {TILES}")


def radix_hist_plain(keys, shift: int, *, block: int = 1024):
    """keys int32[n] (read as uint32, n % block == 0) -> int32[n/block,
    256] counts of ``(key >> shift) & 0xFF`` per block, in plain PyTorch
    (one bincount over ``block_id * 256 + digit``)."""
    n = keys.shape[0]
    _check_blocks(n, block)
    digits = (u32(keys) >> shift) & 0xFF
    blk = torch.arange(n, device=keys.device) // block
    flat = torch.bincount(blk * 256 + digits, minlength=(n // block) * 256)
    return flat.view(n // block, 256).to(torch.int32)


@traffic.reports("radix_hist", lambda keys, shift, *, block=1024:
                 traffic.radix_hist_bytes(keys.shape[0], block))
def radix_hist(keys, shift: int, *, block: int = 1024):
    """Per-block digit histograms, int32 values of shape (n/block, 256);
    the plain version for CPU tensors, the CUDA kernel otherwise.

    The kernel stores the counts digit-major, as a contiguous (256,
    n/block) tensor, and returns its transposed view: the values are the
    JAX layout, and ``digit_major_bases`` scans the storage in place.
    ``meta`` keys get the same view of an empty tensor."""
    if _build.on_cpu(keys):
        return radix_hist_plain(keys, shift, block=block)
    meta = _build.traced("radix_hist", keys)
    n = keys.shape[0]
    check_tile("radix_hist", n, block)
    hist = torch.empty((256, n // block), dtype=torch.int32,
                       device=keys.device)
    if n and not meta:
        _build.launch("radix_hist", keys.data_ptr(), shift, n, block,
                      hist.data_ptr())
    return hist.t()
