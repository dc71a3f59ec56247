"""Rebuild-free BWT merge of adjacent index segments, on the operands'
device (a port of the JAX package's ``core/bwt_merge.py``).

Let ``TA`` / ``TB`` be two segments' prepared texts (sentinel-terminated,
pad-filled documents, ``pipeline.prepare_tokens``) and ``U = TA · TB``.
Suffixes of ``U`` inside ``TB`` are ``TB``'s own, and suffixes inside ``TA``
keep their standalone order when ``TA`` is context-order safe against
``TB`` (``context_order_safe``; a single prepared document always is).  So
``SA(U)`` interleaves the two suffix orders, and ``BWT(U)`` is the
matching interleave of the two BWTs with the two wrap cells exchanged.
The interleave comes from one backward walk over ``TB`` inside the two
indexes:

    I(j) = C_A[c] + Occ_A(c, I(j+1))
           + [c = lastA] * ([rowB < r(j+1)] - [rowA < I(j+1)])
    r(j) = C_B[c] + Occ_B(c, r(j+1)) + [c = lastB] * [r(j+1) <= rowB]

with ``c = BWT_B[r(j+1)]``, ``lastX`` the last character of each text and
``rowX`` the BWT row of its suffix 0, anchored at ``I = C_A[lastB]``,
``r = C_B[lastB]``.  ``merge_kway`` generalizes it to a whole run: one walk
over ``T_1 ··· T_k`` keeps one state per segment,

    I_j <- C_j[c] + Occ_j(c, I_j) + [c = last_j] * (NEXT_j - [row_j < I_j])

with ``NEXT_j = [row_{j+1} < I_{j+1}]`` (1 for the last segment), and the
current suffix's merged position is the sum of the states.  The first
segment is never walked.

Here the walked operands' symbol and LF maps are one batched rank call
per walk, the walked operands' rows at their SA sample's positions seed
the walk's chains, each walk is one launch of the ``merge_walk`` kernel
(``kernels/merge_walk.py``; the plain step loop for CPU tensors), and the
splice, the SA-sample splice and ``build_fm_index`` of the merged BWT run
with torch on the operands' device.  The result is bit-identical to
``pipeline.build_index_prepared`` of the concatenated prepared texts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..kernels.fm_query import packed_symbol
from ..kernels.merge_walk import (
    MAX_CHAIN_LANES,
    Seeds,
    kway_walk,
    merge_walk,
)
from ..testing.faultinject import fault_point
from .fm_index import (
    FMIndex,
    _next_pow2,
    build_fm_index,
    sa_values,
    sample_arrays_from_rows,
    sample_marked_rows,
    stack_rank_arrays,
)


def merge_eligible(left: FMIndex, right: FMIndex) -> str | None:
    """Why the pair cannot BWT-merge, or None when it can (layout
    conditions only: the left operand's context-order safety against the
    right is the caller's to check, ``context_order_safe``)."""
    for side, fm in (("left", left), ("right", right)):
        if not isinstance(fm, FMIndex):
            return f"{side} segment is not a single-device FMIndex"
    sig_l = (left.sigma, left.sample_rate, left.bits, left.sa_sample_rate)
    sig_r = (right.sigma, right.sample_rate, right.bits, right.sa_sample_rate)
    if sig_l != sig_r:
        return f"mixed layouts {sig_l} != {sig_r}"
    for side, fm in (("left", left), ("right", right)):
        if fm.length % fm.sample_rate:
            return f"{side} length {fm.length} not a block multiple"
    if left.sa_sample_rate:
        if left.sa_marks is None or right.sa_marks is None:
            return "missing SA sample arrays"
        if left.length % left.sa_sample_rate:
            return (
                f"SA stride {left.sa_sample_rate} does not divide left "
                f"length {left.length}"
            )
    return None


def _same_device(fms) -> None:
    devices = {fm.device for fm in fms}
    if len(devices) > 1:
        raise ValueError(f"cannot merge: operands on different devices "
                         f"{sorted(map(str, devices))}")


def _rank_rows(fm: FMIndex):
    """(fused, blocks, occ) of one index: what its ranks read."""
    if fm.bits:
        return fm.fused, None, None
    return None, fm.bwt.view(fm.n_blocks, fm.sample_rate), fm.occ_samples[:-1]


def _last(fm: FMIndex) -> torch.Tensor:
    """The last character of the text: BWT at the row of suffix 0."""
    return fm.bwt[fm.row.long()]


def _symbols_lf(fused, blocks, occ, blk, cut, rows, c_of, last, row0, *,
                sigma: int, bits: int) -> torch.Tensor:
    """(symbol, LF) int32[n, 2] of walked rows from one batched rank call:
    row ``rows`` sits in block ``blk`` at ``cut`` of the rank rows;
    ``c_of(c)`` is its index's C[c], ``last`` / ``row0`` its last character
    and the BWT row of its suffix 0 (per row, or one for all)."""
    if bits:
        c_all = packed_symbol(fused, blk, cut, sigma=sigma, bits=bits)
    else:
        c_all = blocks[blk.long(), cut.long()]
    c_all = torch.clamp(c_all, 0, sigma - 1).contiguous()
    lf = (c_of(c_all)
          + ops.rank_walkers(fused, blocks, occ, blk, c_all, cut, bits=bits,
                             sigma=sigma)
          + ((c_all == last) & (rows <= row0)).to(torch.int32))
    return torch.stack([c_all, lf.to(torch.int32)], dim=1).contiguous()


def _pairwise_walk_inputs(left: FMIndex, right: FMIndex):
    """(clf, ends) of a pairwise walk: the right operand's (symbol, LF)
    row pairs int32[nB, 2], from one batched rank call, and int32[4] =
    (rowA, lastA, rowB, lastB)."""
    r = right.sample_rate
    rows = torch.arange(right.length, dtype=torch.int32, device=right.device)
    blk = rows // r
    lastB = _last(right)
    clf = _symbols_lf(*_rank_rows(right), blk, rows - blk * r, rows,
                      lambda c: right.c_array[c.long()], lastB, right.row,
                      sigma=right.sigma, bits=right.bits)
    ends = torch.stack([left.row, _last(left), right.row, lastB]).to(
        torch.int32)
    return clf, ends


def _walk_seeds(fms: list[FMIndex]) -> Seeds | None:
    """The walked operands' own rows at text positions 0, s, 2s, ... (each
    one's SA sample by position, s its rate), back to back: where the
    walk's chains may start.  None without an SA sample."""
    rate = fms[0].sa_sample_rate
    if not rate:
        return None
    parts = []
    for fm in fms:
        by_pos = torch.empty(-(-fm.length // rate), dtype=torch.int32,
                             device=fm.device)
        by_pos[(sa_values(fm) // rate).long()] = sample_marked_rows(fm).to(
            torch.int32)
        parts.append(by_pos)
    return Seeds(torch.cat(parts), rate)


def _splice(fms: list[FMIndex], ins: torch.Tensor, *,
           compress_sa: bool | None = None,
           pack: bool | None = None) -> FMIndex:
    """The merged index from a walk's ``ins`` (the k-way layout: operands
    1 .. k-1 back to back; for a pairwise merge, k = 2 and the right
    operand's): walked rows land at ins + row, the first operand's rows
    fill the complement in order, then the chained wrap exchange (each
    operand's suffix-0 cell holds the previous operand's last character;
    operand 0 the last one's), the SA-sample splice and
    ``build_fm_index``."""
    k = len(fms)
    f0 = fms[0]
    dev = f0.device
    lens = [fm.length for fm in fms]
    offs = np.concatenate([[0], np.cumsum(lens)]).tolist()
    N = offs[-1]
    merged = torch.empty(N, dtype=torch.int32, device=dev)
    is_walked = torch.zeros(N, dtype=torch.bool, device=dev)
    pos = [None] * k
    for s in range(1, k):
        walked = ins[offs[s] - lens[0]: offs[s + 1] - lens[0]]
        pos[s] = walked.long() + torch.arange(lens[s], device=dev)
        is_walked[pos[s]] = True
        merged[pos[s]] = fms[s].bwt[: lens[s]]
    pos[0] = torch.nonzero(~is_walked).flatten()
    merged[pos[0]] = f0.bwt[: lens[0]]
    lasts = [_last(fm) for fm in fms]
    for s in range(k):
        merged[pos[s][fms[s].row.long()]] = lasts[(s - 1) % k]
    # the SA sample: each operand's marked rows at their merged positions,
    # values shifted by its text offset, re-packed at the merged width
    srate = f0.sa_sample_rate
    sa_samples = None
    if srate:
        rows_m = torch.cat([p[sample_marked_rows(fm)]
                            for fm, p in zip(fms, pos)])
        vals_m = torch.cat([sa_values(fm) + off
                            for fm, off in zip(fms, offs)])
        order = torch.sort(rows_m, stable=True).indices
        sa_samples = sample_arrays_from_rows(
            rows_m[order], vals_m[order].to(torch.int32), N, srate,
            compress=compress_sa)
    return build_fm_index(
        merged, pos[0][f0.row.long()], f0.sigma, f0.sample_rate,
        pack=bool(f0.bits) if pack is None else pack,
        sa_samples=sa_samples, sa_sample_rate=srate,
    )


def merge_fm_indexes(
    left: FMIndex, right: FMIndex, *, compress_sa: bool | None = None,
    pack: bool | None = None,
) -> FMIndex:
    """BWT of ``T_left · T_right`` from the two built indexes, no sort.

    Precondition (not checkable from the indexes): ``left``'s text is
    context-order safe against ``right``'s; ``right`` may be any document
    concatenation.  ``merge_eligible`` must return None.  ``compress_sa`` /
    ``pack`` as in ``build_fm_index``."""
    reason = merge_eligible(left, right)
    if reason:
        raise ValueError(f"cannot merge: {reason}")
    _same_device((left, right))
    clf, ends = _pairwise_walk_inputs(left, right)
    fused, blocks, occ = _rank_rows(left)
    ins = merge_walk(fused, blocks, occ, left.c_array, right.c_array, clf,
                     ends, _walk_seeds([right]), sigma=left.sigma,
                     bits=left.bits, r=left.sample_rate)
    # a crash here leaves the operands untouched and no merged index
    fault_point("merge.mid")
    return _splice([left, right], ins, compress_sa=compress_sa, pack=pack)


# -- k-way merge --------------------------------------------------------------

def context_order_safe(text, continuation, *, budget: int = 1 << 24) -> bool:
    """True when ``text``'s standalone suffix order survives having
    ``continuation`` appended after it (exact, token-level).

    A standalone suffix that is a proper prefix of another sorts first;
    in context the pair flips iff the continuation ``G`` compares greater.
    Every tied pair shares its outcome with the length-1 tie at the same
    internal position, so safety reduces to: for every p < n-1 with
    ``text[p] == text[-1]``, require ``G <= text[p+1:] + G``.  Returns
    False, conservatively, when the scan exceeds ``budget`` token
    comparisons."""
    T = np.asarray(text, np.int64)
    G = np.asarray(continuation, np.int64)
    n, g = len(T), len(G)
    if n == 0 or g == 0:
        return True
    S = np.concatenate([T[1:], G])  # S[p:] = text[p+1:] + G
    cand = np.nonzero(T[:-1] == T[-1])[0]
    work, i = cand.size, 0
    while cand.size and i < g:
        if work > budget:
            return False
        s = S[cand + i]
        if np.any(s < G[i]):
            return False        # the longer suffix's side is smaller: flip
        cand = cand[s == G[i]]  # still tied: compare one token deeper
        work += cand.size
        i += 1
    # survivors tie through all of G: the shorter suffix ends first and
    # sorts first, matching the standalone order
    return True


def kway_eligible(fms: list[FMIndex]) -> str | None:
    """Why this ordered run of indexes cannot k-way merge, or None (layout
    conditions only: context-order safety of every operand but the last
    is the caller's to check)."""
    if len(fms) < 2:
        return "k-way merge needs at least 2 segments"
    for i, fm in enumerate(fms):
        if not isinstance(fm, FMIndex):
            return f"segment {i} is not a single-device FMIndex"
    f0 = fms[0]
    sig0 = (f0.sigma, f0.sample_rate, f0.bits, f0.sa_sample_rate)
    for i, fm in enumerate(fms):
        sig = (fm.sigma, fm.sample_rate, fm.bits, fm.sa_sample_rate)
        if sig != sig0:
            return f"mixed layouts {sig} != {sig0}"
        if fm.length % fm.sample_rate:
            return f"segment {i} length {fm.length} not a block multiple"
        if f0.sa_sample_rate:
            if fm.sa_marks is None:
                return "missing SA sample arrays"
            if i < len(fms) - 1 and fm.length % f0.sa_sample_rate:
                return (
                    f"SA stride {f0.sa_sample_rate} does not divide "
                    f"segment {i} length {fm.length}"
                )
    return None


def kway_walk_steps(lengths) -> int:
    """Sequential rank steps of a k-way merge over prepared ``lengths``:
    everything but the first text is walked, minus the anchor state.  The
    pairwise fold (largest text leftmost) pays the same count."""
    lengths = list(lengths)
    return max(0, sum(lengths[1:]) - 1)


def _kway_walk_inputs(fms: list[FMIndex]):
    """The k-way walk's arguments: ``stack_rank_arrays`` at ``k_pad`` =
    next power of two lanes, each segment's suffix-0 row and last
    character (0 for pad lanes), the real lengths, the walked segments'
    (symbol, LF) rows in ``ins``'s layout from one batched rank call over
    the stacked rows, and their seeds (``_walk_seeds``; None past
    ``MAX_CHAIN_LANES`` segments, where the walk is one chain)."""
    k = len(fms)
    k_pad = _next_pow2(k)
    f0, dev = fms[0], fms[0].device
    fused, blocks, occ, c_mat, nb_vec, NB = stack_rank_arrays(fms,
                                                              seg_pad=k_pad)
    pad = torch.zeros(k_pad - k, dtype=torch.int32, device=dev)
    row_vec = torch.cat([torch.stack([fm.row for fm in fms]).to(torch.int32),
                         pad])
    last_vec = torch.cat([torch.stack([_last(fm) for fm in fms]).to(
        torch.int32), pad])
    lens = [fm.length for fm in fms]
    n = sum(lens[1:])
    walked = torch.tensor(lens[1:], device=dev)
    seg = torch.repeat_interleave(
        torch.arange(1, k, dtype=torch.int32, device=dev), walked,
        output_size=n)
    first = torch.cumsum(walked, 0) - walked
    rows = (torch.arange(n, dtype=torch.int32, device=dev)
            - first.repeat_interleave(walked, output_size=n).to(torch.int32))
    r = f0.sample_rate
    blk = rows // r
    clf = _symbols_lf(fused, blocks, occ, seg * NB + blk, rows - blk * r,
                      rows, lambda c: c_mat[seg.long(), c.long()],
                      last_vec[seg.long()], row_vec[seg.long()],
                      sigma=f0.sigma, bits=f0.bits)
    seeds = _walk_seeds(fms[1:]) if k <= MAX_CHAIN_LANES else None
    return (fused, blocks, occ, c_mat, nb_vec, row_vec, last_vec, lens, clf,
            seeds)


def merge_kway(
    fms: list[FMIndex], *, compress_sa: bool | None = None,
    pack: bool | None = None,
) -> FMIndex:
    """BWT of ``T_1 ··· T_k`` spliced from the k built indexes: one
    interleave walk, no sort, no intermediate accumulators.

    Precondition (not checkable from the indexes): every operand but the
    last is context-order safe against the concatenation following it.
    ``kway_eligible`` must return None.  The first operand is never
    walked; the others LF-step right to left in one chained pass.
    Bit-identical to ``build_index_prepared`` on the same concatenation
    and to the pairwise fold."""
    reason = kway_eligible(fms)
    if reason:
        raise ValueError(f"cannot merge: {reason}")
    _same_device(fms)
    f0 = fms[0]
    ins = kway_walk(*_kway_walk_inputs(fms), sigma=f0.sigma, bits=f0.bits,
                    r=f0.sample_rate)
    # a crash here leaves the operands untouched and no merged index
    fault_point("merge.kway")
    fault_point("merge.mid")
    return _splice(fms, ins, compress_sa=compress_sa, pack=pack)
