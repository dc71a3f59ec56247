"""Public kernel entry points, with the JAX package's ``kernels/ops.py``
signatures.

The kernel wrappers (``rank_packed``, ``rank_select``, ``radix_hist``,
``radix_pos``, ``rerank_scan``, ``char_histogram``, ``fm_query_packed``,
``fm_query_unpacked``, ``fm_query_stacked_packed``,
``fm_query_stacked_unpacked``) dispatch on their tensors' device: CPU tensors take
the plain PyTorch version, CUDA tensors launch the hand-written kernel (or
raise).  No argument or environment variable reroutes a CUDA tensor to
plain code.  Launches are counted in ``_build.LAUNCHES``.
"""

from __future__ import annotations

import torch

from . import char_histogram as _char_histogram
from . import rerank_scan as _rerank_scan
from .fm_query import fm_query_packed, fm_query_unpacked  # noqa: F401
from .fm_query import (  # noqa: F401  (re-export)
    fm_query_stacked_packed,
    fm_query_stacked_unpacked,
)
from .radix_hist import TILE
from .radix_hist import radix_hist  # noqa: F401  (re-export)
from .radix_sort import radix_pos  # noqa: F401  (re-export)
from .radix_sort import radix_sort_blocked, radix_sort_plain
from .rank_select import rank_packed  # noqa: F401  (re-export)
from .rank_select import rank_select

COMPARE = "compare"
RADIX = "radix"
_INT32_MIN = -(1 << 31)


def char_histogram(tokens, sigma: int, *, block_rows: int = 8):
    """Histogram of token values: int32[n] -> int32[sigma]; values outside
    [0, sigma) count nowhere.  ``block_rows`` is the JAX signature's TPU
    tile height and changes no result."""
    del block_rows
    return _char_histogram.char_histogram(tokens, sigma)


def rerank_scan(r1, r2, *, block: int = 512):
    """(ranks int32[n], num_groups int32 scalar tensor) for sorted key pairs
    ``r1``/``r2`` int32[n]: rank = index of each pair's first occurrence.
    ``block`` is the JAX signature's TPU block and changes no result."""
    del block
    return _rerank_scan.rerank_scan(r1, r2)


def resolve_sort_engine(engine: str, device) -> str:
    """"auto" -> the device default: the radix engine (the CUDA kernels) on
    the GPU, the stable compare sort on the CPU, mirroring the JAX
    package's radix-on-TPU / compare-elsewhere rule."""
    if engine == "auto":
        return RADIX if torch.device(device).type == "cuda" else COMPARE
    if engine not in (COMPARE, RADIX):
        raise ValueError(f"unknown local_sort engine {engine!r}")
    return engine


def _compare_sort(operands, num_keys: int):
    """Stable LSD sort by whole key words (least-significant first), each
    word ordered as unsigned: flipping the sign bit maps unsigned order
    onto signed order, so q-gram words that fill all 32 bits (negative as
    int32) still sort last."""
    arrs = list(operands)
    for w in range(num_keys - 1, -1, -1):
        perm = torch.sort(arrs[w] ^ _INT32_MIN, stable=True).indices
        arrs = [a[perm] for a in arrs]
    return tuple(arrs)


def local_sort(operands, num_keys: int, *, engine: str = COMPARE,
               key_bits=None):
    """Stable sort of int32 key words (most-significant first, read as
    unsigned) + payloads by the chosen engine: ``"compare"`` (stable
    ``torch.sort`` per key word) or ``"radix"`` (the LSD radix pipeline).
    Both are stable, so they are interchangeable bit for bit."""
    operands = tuple(operands)
    if engine == RADIX:
        if key_bits is None:
            key_bits = (32,) * num_keys
        return radix_sort(operands, num_keys=num_keys,
                          key_bits=tuple(key_bits))
    if engine != COMPARE:
        raise ValueError(f"unknown local_sort engine {engine!r}")
    return _compare_sort(operands, num_keys)


def radix_sort(operands, *, num_keys: int, key_bits, block: int = TILE):
    """Stable LSD radix sort of key words (MSW first) + payloads.

    ``key_bits[w]`` bounds the significant bits of word ``w``; digits above
    it are never examined, so pads must be field-limited.  CUDA tensors go
    through the hist/scatter kernels over tiles of ``block`` keys (one of
    ``radix_hist.TILES``; the default is the card's tile, where the JAX
    signature has its 1024-key TPU block); CPU tensors through the plain
    counting sort.  The tile changes no result: every pass is stable."""
    operands = tuple(operands)
    key_bits = tuple(key_bits)
    if all(a.device.type == "cpu" for a in operands):
        return radix_sort_plain(operands, num_keys, key_bits)
    return radix_sort_blocked(operands, num_keys, key_bits, block=block)


# the JAX package's batched unpacked rank: the same kernel wrapper here
rank_unpacked = rank_select


def rank_walkers(fused, blocks, occ, block_idx, c, cutoff, *, bits: int,
                 sigma: int):
    """Full Occ(c_i, block_idx_i * r + cutoff_i) on either block layout in
    one batched call: ``rank_packed`` over ``fused`` rows when ``bits`` >
    0, else the flat per-block checkpoints ``occ`` int32[n_blocks, sigma]
    plus the unpacked in-block rank over ``blocks``.  ``block_idx`` may
    address a stacked multi-segment array (``fm_index.stack_rank_arrays``)
    with the segment base folded in by the caller.  The BWT merge calls it
    once per walk for the walked operands' LF maps; its walks run in the
    ``merge_walk`` kernel."""
    if bits:
        return rank_packed(fused, block_idx, c, cutoff,
                           bits=bits, sigma=sigma)
    return occ[block_idx.long(), c.long()] + rank_unpacked(
        blocks, block_idx, c, cutoff)
