"""Distributed FM-index: a sharded (bit-packed) BWT and rank queries joined
by a psum.

A rank query decomposes over position ranges,

    Occ(c, p) = sum over ranks d of (count of c in rank d's range ∩ [0, p)),

so each rank answers from its own checkpoints plus one in-block count, and
one ``psum`` combines the partials: O(B) bytes of collective traffic per
backward-search step for a batch of B queries, independent of n.

Each rank holds its shard (``m = n / P`` symbols) of the BWT, its
exclusive Occ checkpoints and, when the alphabet packs (sigma <= 16), its
fused [checkpoint | packed words] rows; ``c_array``, ``row`` and the SA
sample are replicated, as in the JAX package's ``DistFMIndex`` (whose
arrays are global; here every array field is this rank's).  The local rank
goes through ``kernels/ops``: the single-batch ``rank_packed`` kernel over
the fused rows, or the unpacked ``rank_select`` kernel plus the
checkpoints, on CUDA tensors.

``dist_count`` runs the backward search with two rank calls and two psums
a pattern position; ``dist_locate`` LF-walks every candidate row to the
replicated SA sample, one psum'd BWT-symbol gather plus one psum'd rank a
step, for ``sa_sample_rate`` steps.  Every rank issues the same batches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from ..kernels.fm_query import PAD, sample_lookup
from ..kernels.rank_select import pack_words, packed_bits
from .dist_sort import (
    ShardInfo,
    _me,
    all_gather,
    mesh_parts,
    psum,
    shard_info,
)
from .fm_index import occ_checkpoints, sample_arrays_from_rows

AXIS = "parts"  # the index mesh's one dimension (launch/mesh.py)


@dataclasses.dataclass(frozen=True)
class DistFMIndex:
    """One rank's part of a distributed FM index."""

    bwt: torch.Tensor          # int32[m]            this rank's shard
    occ_samples: torch.Tensor  # int32[m/r, sigma]   exclusive, per shard
    c_array: torch.Tensor      # int32[sigma]        replicated
    row: torch.Tensor          # int32 scalar        replicated
    fused: torch.Tensor | None          # int32[m/r, sigma+W] (packed)
    sa_marks: torch.Tensor | None       # int32[ceil(n/32)]  replicated
    sa_mark_ranks: torch.Tensor | None
    sa_vals: torch.Tensor | None        # raw int32, or packed (sa_val_bits)
    sample_rate: int
    sigma: int
    length: int              # global n
    parts: int
    bits: int                # packed field width (0 = unpacked layout)
    sa_sample_rate: int      # 0 = locate unavailable
    sa_val_bits: int = 0     # bits per packed SA value (0 = raw int32)

    @property
    def device(self) -> torch.device:
        return self.bwt.device


DIST_ARRAY_FIELDS = ("bwt", "occ_samples", "c_array", "row", "fused",
                     "sa_marks", "sa_mark_ranks", "sa_vals")
DIST_AUX_FIELDS = ("sample_rate", "sigma", "length", "parts", "bits",
                   "sa_sample_rate", "sa_val_bits")
SHARDED_FIELDS = ("bwt", "occ_samples", "fused")   # the rest replicate


def _build_local(info: ShardInfo, bwt_local: torch.Tensor, *, sigma: int,
                 sample_rate: int, bits: int):
    """This shard's exclusive Occ checkpoints (+ fused packed rows) and
    the global C array (the shards' symbol totals, psum'd)."""
    nblocks = bwt_local.shape[0] // sample_rate
    counts = psum(info, ops.char_histogram(bwt_local, sigma))
    c_array = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    occ_local = occ_checkpoints(bwt_local, sigma, sample_rate)[:-1]
    fused = None
    if bits:
        words = pack_words(bwt_local, bits).view(nblocks, -1)
        fused = torch.cat([occ_local, words], dim=1)
    return occ_local, fused, c_array


def gather_sa_samples(info: ShardInfo, sa_local: torch.Tensor,
                      sa_sample_rate: int, *, compress: bool | None = None):
    """The replicated SA sample (marks, mark_ranks, vals, val_bits) from
    the SA's shards, equal to ``fm_index.build_sa_samples`` over the whole
    SA: each rank gathers every rank's marked rows and their values (two
    all_gathers: the counts, then the rows and values padded to the
    largest count)."""
    lo = _me(info) * info.part_size
    rows = torch.nonzero(torch.remainder(sa_local, sa_sample_rate) == 0)
    rows = rows.flatten()
    vals = sa_local[rows]
    counts = all_gather(info, torch.tensor([rows.numel()],
                                           device=sa_local.device))
    counts = counts.flatten().tolist()
    width = max(counts)
    mine = torch.zeros((2, width), dtype=torch.int64, device=sa_local.device)
    mine[0, : rows.numel()] = rows + lo
    mine[1, : rows.numel()] = vals
    every = all_gather(info, mine)                     # (P, 2, width)
    rows_g = torch.cat([every[p, 0, :c] for p, c in enumerate(counts)])
    vals_g = torch.cat([every[p, 1, :c] for p, c in enumerate(counts)])
    return sample_arrays_from_rows(rows_g, vals_g.to(torch.int32), info.n,
                                   sa_sample_rate, compress=compress)


def build_dist_fm_index(
    bwt_local: torch.Tensor, row, mesh, *, sigma: int, sample_rate: int = 64,
    sa: torch.Tensor | None = None, sa_sample_rate: int = 32,
    pack: bool | None = None, compress_sa: bool | None = None,
    sa_samples: tuple | None = None,
) -> DistFMIndex:
    """This rank's part of the FM index over its BWT shard ``bwt_local``
    int32[m] (n = parts * m, m divisible by ``sample_rate``): Occ
    checkpoints (+ fused packed rows when the alphabet fits).  ``sa`` (this
    rank's SA shard) / ``sa_sample_rate`` / ``compress_sa`` add the
    replicated SA sample for ``dist_locate``; ``sa_samples`` injects
    prebuilt (marks, ranks, vals, val_bits)."""
    m = bwt_local.shape[0]
    parts = mesh_parts(mesh)
    n = parts * m
    if m % sample_rate:
        raise ValueError(
            f"n={n} must be divisible by parts*sample_rate={parts}*"
            f"{sample_rate}")
    bits = 0 if pack is False else packed_bits(sigma, sample_rate)
    if pack and not bits:
        raise ValueError(
            f"cannot pack sigma={sigma} at sample_rate={sample_rate}")
    info = shard_info(mesh, n)
    occ_samples, fused, c_array = _build_local(
        info, bwt_local, sigma=sigma, sample_rate=sample_rate, bits=bits)
    if sa_samples is not None:
        sa_marks, sa_mark_ranks, sa_vals, sa_val_bits = sa_samples
    elif sa is not None:
        sa_marks, sa_mark_ranks, sa_vals, sa_val_bits = gather_sa_samples(
            info, sa, sa_sample_rate, compress=compress_sa)
    else:
        sa_marks = sa_mark_ranks = sa_vals = None
        sa_sample_rate = sa_val_bits = 0
    row = torch.as_tensor(row, dtype=torch.int32, device=bwt_local.device)
    return DistFMIndex(bwt_local, occ_samples, c_array, row, fused, sa_marks,
                       sa_mark_ranks, sa_vals, sample_rate, sigma, n, parts,
                       bits, sa_sample_rate, sa_val_bits)


def _occ_partial(info: ShardInfo, index: DistFMIndex, c, p):
    """Count of c in (my range ∩ [0, p)), batched, on this shard's layout.
    ``p_loc == m`` folds into the last block (cutoff r), so checkpoint +
    in-block covers exactly [0, m) with no tail case."""
    m = info.part_size
    r = index.sample_rate
    p_loc = torch.clamp(p - _me(info) * m, 0, m)
    block = torch.clamp(p_loc // r, max=m // r - 1)
    cut = p_loc - block * r
    if index.bits:
        return ops.rank_packed(index.fused, block, c, cut,
                               bits=index.bits, sigma=index.sigma)
    base = index.occ_samples[block.long(), c.long()]
    inblock = ops.rank_unpacked(index.bwt.view(m // r, r), block, c, cut)
    return base + inblock


def _search(info: ShardInfo, index: DistFMIndex, patterns: torch.Tensor):
    """Batched backward search over replicated patterns, right to left:
    (sp, ep) per pattern."""
    B, L = patterns.shape
    sigma = index.sigma
    sp = torch.zeros(B, dtype=torch.int32, device=patterns.device)
    ep = torch.full((B,), index.length, dtype=torch.int32,
                    device=patterns.device)
    for j in range(L - 1, -1, -1):   # PADs on the right come first
        c = patterns[:, j].contiguous()
        in_alphabet = (c >= 1) & (c < sigma)
        valid = in_alphabet & (ep > sp)
        c_safe = torch.where(in_alphabet, c, 0)
        occ_sp = psum(info, _occ_partial(info, index, c_safe, sp))
        occ_ep = psum(info, _occ_partial(info, index, c_safe, ep))
        base = index.c_array[c_safe.long()]
        sp = torch.where(valid, base + occ_sp, sp)
        # out-of-alphabet symbols (not PAD) empty the interval permanently
        ep = torch.where(valid, base + occ_ep,
                         torch.where((c != PAD) & ~in_alphabet, sp, ep))
    return sp, ep


def _info(index: DistFMIndex, mesh) -> ShardInfo:
    if mesh_parts(mesh) != index.parts:
        raise ValueError(f"index of {index.parts} parts on a mesh of "
                         f"{mesh_parts(mesh)}")
    return shard_info(mesh, index.length)


def dist_count(index: DistFMIndex, patterns: torch.Tensor, mesh
               ) -> torch.Tensor:
    """Batched exact-match counts over the sharded index: int32[B, L]
    PAD-padded patterns (the same on every rank) -> int32[B]."""
    sp, ep = _search(_info(index, mesh), index, patterns)
    return torch.clamp(ep - sp, min=0)


def dist_locate(index: DistFMIndex, patterns: torch.Tensor, k: int, mesh):
    """First-k occurrence positions per pattern over the sharded index:
    (positions int32[B, k] sorted ascending, n-filled; counts int32[B]
    clipped to k), the contract of ``fm_index.locate``."""
    if index.sa_sample_rate == 0:
        raise ValueError("index built without sa= — locate unavailable")
    info = _info(index, mesh)
    sp, ep = _search(info, index, patterns)
    B = sp.shape[0]
    dev = sp.device
    m = info.part_size
    lo = _me(info) * m
    rows = sp[:, None] + torch.arange(k, dtype=torch.int32, device=dev)
    valid = (rows < ep[:, None]).reshape(-1)
    rows = torch.where(valid, rows.reshape(-1), 0)
    pos = torch.zeros(B * k, dtype=torch.int32, device=dev)
    steps = torch.zeros_like(pos)
    done = ~valid
    s = index.sa_sample_rate
    for _ in range(s if k else 0):
        marked, val = sample_lookup(index.sa_marks, index.sa_mark_ranks,
                                    index.sa_vals, rows,
                                    val_bits=index.sa_val_bits, val_scale=s)
        pos = torch.where(marked & ~done, val + steps, pos)
        done = done | marked
        loc = rows - lo
        inside = (loc >= 0) & (loc < m)
        sym = torch.where(inside, index.bwt[torch.clamp(loc, 0, m - 1).long()],
                          0)
        c = psum(info, sym)
        nxt = index.c_array[c.long()] + psum(
            info, _occ_partial(info, index, c, rows))
        rows = torch.where(done, rows, nxt)
        steps = steps + torch.where(done, 0, 1).to(torch.int32)
    out = torch.where(valid, pos, index.length).reshape(B, k)
    return torch.sort(out, dim=1).values, torch.clamp(ep - sp, 0, k)
