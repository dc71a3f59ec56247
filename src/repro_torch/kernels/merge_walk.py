"""The interleave walks of the rebuild-free BWT merge (``core/bwt_merge``),
each as one launch of ``csrc/merge_walk.cu``, with plain PyTorch versions.

A walk LF-steps suffixes right to left and, for every walked row, records
``ins``: how many suffixes of the other operand(s) sort before it (its
merged position is ``ins + row``).  The JAX package runs each walk as a
``lax.fori_loop`` with one batched rank call per step (``_merge_walk`` and
``_kway_walk`` of its ``core/bwt_merge.py``); the plain versions here are
those loop bodies step by step in eager PyTorch over the plain rank
functions, so they call no kernel on any device.

* ``merge_walk`` (pairwise): the right operand's rows walked through the
  left index.  The right side enters as ``clf`` int32[nB, 2], each row's
  (symbol, LF) pair, computed once per merge by a batched rank call.
* ``kway_walk``: one walker lane per segment of a run over the
  ``fm_index.stack_rank_arrays`` layout; segments k-1 .. 1 are walked in
  one chained pass and ``ins`` holds them back to back at their real
  lengths.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise; operands on different devices raise ``ValueError``.  Launches are
counted in ``_build.LAUNCHES["merge_walk"]``.
"""

from __future__ import annotations

import torch

from . import _build, traffic
from .fm_query import packed_symbol
from .rank_select import rank_packed_plain, rank_select_plain


def _rank_plain(fused, blocks, occ, blk, c, cut, *, bits: int, sigma: int):
    """``ops.rank_walkers`` over the plain rank functions."""
    if bits:
        return rank_packed_plain(fused, blk, c, cut, bits=bits, sigma=sigma)
    return occ[blk.long(), c.long()] + rank_select_plain(blocks, blk, c, cut)


def _layout(name: str, fused, blocks, occ, *, sigma: int, bits: int,
            r: int):
    """(the layout's tensors, their row count); raises unless the rows
    match (sigma, bits, r): the kernel addresses them with these values
    unchecked."""
    if bits:
        ok = (fused is not None and bits in (2, 4) and sigma <= 1 << bits
              and fused.dim() == 2
              and fused.shape[1] == sigma + r * bits // 32)
        tensors = (fused,)
    else:
        ok = (blocks is not None and occ is not None and blocks.dim() == 2
              and blocks.shape[1] == r
              and tuple(occ.shape) == (blocks.shape[0], sigma))
        tensors = (blocks, occ)
    if not ok or tensors[0].shape[0] < 1:
        raise ValueError(f"{name}: rows do not match sigma={sigma}, "
                         f"bits={bits}, r={r}")
    return tensors, tensors[0].shape[0]


def _on_cpu(name: str, *tensors) -> bool:
    """The wrappers' dispatch: all on the CPU -> plain; otherwise every
    tensor must be a contiguous int32 tensor on one CUDA device."""
    if len({t.device for t in tensors}) > 1:
        raise ValueError(f"{name}: operands on different devices")
    if _build.on_cpu(*tensors):
        return True
    _build.check_cuda(name, *tensors)
    return False


def _layout_args(fused, blocks, occ, sigma: int):
    """(fused, blocks, occ, row width) C arguments of either layout."""
    if fused is not None:
        return fused.data_ptr(), None, None, fused.shape[1]
    return None, blocks.data_ptr(), occ.data_ptr(), sigma


# -- pairwise -----------------------------------------------------------------

def merge_walk_plain(a_fused, a_blocks, a_occ, a_c, b_c, clf, ends, *,
                     sigma: int, bits: int, r: int):
    """The plain pairwise walk: one rank of the left operand per step.

    ``a_*``: the left operand's rows (fused, or blocks [nbA, r] plus
    checkpoints [nbA, sigma]) and C array; ``b_c`` the right's C array;
    ``clf`` its (symbol, LF) rows; ``ends`` int32[4] = (rowA, lastA, rowB,
    lastB), each side's BWT row of suffix 0 and its last character.
    Returns ins int32[nB]."""
    nB = clf.shape[0]
    nbA = (a_fused if bits else a_blocks).shape[0]
    rowA, lastA, rowB, lastB = ends.long()
    sym, lf = clf[:, 0], clf[:, 1]
    ins = torch.zeros(nB, dtype=torch.int32, device=clf.device)
    # anchor: the length-1 suffix TB[nB-1:] sorts before every longer
    # suffix sharing its first character lastB
    I, rr = a_c[lastB], b_c[lastB].long()
    ins[rr] = I
    for _ in range(nB - 1):
        c = sym[rr]
        corr = torch.where(c == lastA, (rowB < rr).int() - (rowA < I).int(),
                           0)
        blk = torch.clamp(I // r, max=nbA - 1)
        occ = _rank_plain(a_fused, a_blocks, a_occ, blk[None], c[None],
                          (I - blk * r)[None], bits=bits, sigma=sigma)[0]
        I = (a_c[c.long()] + occ + corr).to(torch.int32)
        rr = lf[rr].long()
        ins[rr] = I
    return ins


@traffic.reports("merge_walk", lambda a_fused, a_blocks, a_occ, a_c, b_c,
                 clf, ends, **_: traffic.walk_bytes(
                     clf.shape[0], a_c, b_c, clf, ends) + 4 * clf.shape[0])
def merge_walk(a_fused, a_blocks, a_occ, a_c, b_c, clf, ends, *, sigma: int,
               bits: int, r: int):
    """Pairwise interleave counts ins int32[nB] (``merge_walk_plain``'s
    contract); one kernel launch for CUDA tensors."""
    rows, nbA = _layout("merge_walk", a_fused, a_blocks, a_occ, sigma=sigma,
                        bits=bits, r=r)
    if _on_cpu("merge_walk", *rows, a_c, b_c, clf, ends):
        return merge_walk_plain(a_fused, a_blocks, a_occ, a_c, b_c, clf,
                                ends, sigma=sigma, bits=bits, r=r)
    if (clf.dim() != 2 or clf.shape[1] != 2 or ends.numel() != 4
            or a_c.numel() != sigma or b_c.numel() != sigma):
        raise ValueError("merge_walk: clf must be int32[nB, 2], ends "
                         "int32[4], each C array int32[sigma]")
    nB = clf.shape[0]
    ins = torch.empty(nB, dtype=torch.int32, device=clf.device)
    if nB:
        _build.launch("merge_walk",
                      *_layout_args(a_fused, a_blocks, a_occ, sigma), nbA,
                      sigma, bits, r, a_c.data_ptr(), b_c.data_ptr(),
                      clf.data_ptr(), nB, ends.data_ptr(), ins.data_ptr())
    return ins


# -- k-way --------------------------------------------------------------------

def kway_walk_plain(fused, blocks, occ, c_mat, nb_vec, row_vec, last_vec,
                    lens, *, sigma: int, bits: int, r: int):
    """The plain k-way walk: one batched rank over every lane per step.

    ``fused`` / ``blocks`` + ``occ``, ``c_mat`` [k_pad, sigma] and
    ``nb_vec`` [k_pad] as ``stack_rank_arrays`` gives them; ``row_vec`` /
    ``last_vec`` [k_pad] each segment's BWT row of suffix 0 and last
    character (0 for pad lanes); ``lens`` the k real lengths (host ints).
    Returns ins int32[sum(lens[1:])]: segment s's rows at offset
    sum(lens[1:s])."""
    k, k_pad = len(lens), c_mat.shape[0]
    nb_pad = (fused if bits else blocks).shape[0] // k_pad
    dev = c_mat.device
    lanes = torch.arange(k_pad, dtype=torch.int32, device=dev)
    active = lanes < k
    anchor = lanes == k - 1
    offs = [0, 0]
    for n in lens[1:]:
        offs.append(offs[-1] + n)
    ins = torch.zeros(offs[-1], dtype=torch.int32, device=dev)

    def symbol_at(seg, rank):
        blk = seg * nb_pad + rank // r
        if bits:
            return packed_symbol(fused, blk, rank % r, sigma=sigma, bits=bits)
        return blocks[blk.long(), (rank % r).long()]

    def record(seg, I_vec):
        ins[offs[seg] + I_vec[seg].long()] = (I_vec.sum() - I_vec[seg]).to(
            torch.int32)

    # anchor: U's length-1 suffix sorts before every longer suffix sharing
    # its first character, in every segment's order at once
    seg, pos = k - 1, lens[k - 1] - 1
    I_vec = torch.where(active, c_mat[lanes.long(), last_vec[seg].long()], 0)
    record(seg, I_vec)
    for _ in range(sum(lens[1:]) - 1):
        boundary = pos == 0
        # the symbol to prepend: the walked segment's BWT at its own rank,
        # or at a boundary the previous segment's last character
        if boundary:
            c = last_vec[seg - 1]
        else:
            c = torch.clamp(symbol_at(seg, I_vec[seg]), 0, sigma - 1)
        # wrap corrections from the pre-update states
        cmp = (row_vec < I_vec).int()
        nxt = torch.where(anchor, 1, torch.roll(cmp, -1))
        corr = torch.where(last_vec == c, nxt - cmp, 0)
        blk = torch.minimum(I_vec // r, nb_vec - 1)
        occ_ = _rank_plain(fused, blocks, occ, lanes * nb_pad + blk,
                           c.expand(k_pad).to(torch.int32).contiguous(),
                           I_vec - blk * r, bits=bits, sigma=sigma)
        I_vec = torch.where(active, c_mat[lanes.long(), c.long()] + occ_
                            + corr, 0).to(torch.int32)
        if boundary:
            seg -= 1
            pos = lens[seg] - 1
        else:
            pos -= 1
        record(seg, I_vec)
    return ins


@traffic.reports("merge_walk", lambda fused, blocks, occ, c_mat, nb_vec,
                 row_vec, last_vec, lens, **_: traffic.walk_bytes(
                     sum(lens[1:]), c_mat, nb_vec, row_vec, last_vec)
                 + 4 * sum(lens[1:]))
def kway_walk(fused, blocks, occ, c_mat, nb_vec, row_vec, last_vec, lens, *,
              sigma: int, bits: int, r: int):
    """K-way interleave counts (``kway_walk_plain``'s contract); one kernel
    launch for CUDA tensors."""
    rows, n_rows = _layout("kway_walk", fused, blocks, occ, sigma=sigma,
                           bits=bits, r=r)
    if _on_cpu("kway_walk", *rows, c_mat, nb_vec, row_vec, last_vec):
        return kway_walk_plain(fused, blocks, occ, c_mat, nb_vec, row_vec,
                               last_vec, lens, sigma=sigma, bits=bits, r=r)
    k = len(lens)
    k_pad = c_mat.shape[0]
    if (k < 2 or c_mat.dim() != 2 or k_pad < k or c_mat.shape[1] != sigma
            or n_rows % k_pad
            or min(v.numel() for v in (nb_vec, row_vec, last_vec)) < k):
        raise ValueError(f"kway_walk: bad run (k={k}, c_mat "
                         f"{tuple(c_mat.shape)}, {n_rows} stacked rows)")
    nb_pad = n_rows // k_pad
    len_vec = torch.tensor(lens, dtype=torch.int32, device=c_mat.device)
    ins = torch.empty(sum(lens[1:]), dtype=torch.int32, device=c_mat.device)
    _build.launch("merge_walk", *_layout_args(fused, blocks, occ, sigma),
                  nb_pad, sigma, bits, r, c_mat.data_ptr(), nb_vec.data_ptr(),
                  row_vec.data_ptr(), last_vec.data_ptr(), len_vec.data_ptr(),
                  k, ins.data_ptr(), entry="merge_walk_kway")
    return ins

