"""The bytes each hand-written kernel must move, reported to a counter.

A dispatch mode (``launch/roofline.py`` ``count``) sees every aten op, but
not the kernels: they launch through ``ctypes`` (``_build.launch``).  So
each kernel wrapper is decorated with ``reports(name, nbytes)``.  While a
counter is recording on this thread (``recording``), a wrapper's call is a
scope: the aten ops inside it (the plain version on the CPU; allocations
around the launch on the card) are the counter's ``in_scope`` bytes, and
``nbytes(*args, **kwargs)`` — each input read once, each output written
once, computed from the call's arguments — is what the call adds to the
counted bytes, on either device.  A CPU run thus counts what the card's
kernels move, and shows beside it what the plain versions moved.  With no
counter recording, a wrapper runs as it is (one thread-local read).

The reckonings are the ones ``chip_smoke.py`` holds each kernel's time
against: the rank kernels' distinct 32-byte sectors, the fused query
kernels' replay (``query_bytes``), the radix, histogram and re-rank
streams.  A merge walk is a chain of dependent loads: it reports one
sector a step beside its own inputs and outputs.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import types

import torch

_local = threading.local()
RECKONING = object()     # the scope while ``nbytes`` runs: nothing counts


def current_scope():
    """The kernel whose wrapper call is open on this thread (its name), the
    ``RECKONING`` marker, or None."""
    return getattr(_local, "scope", None)


def counting() -> bool:
    """Whether a counter is recording on this thread."""
    return bool(getattr(_local, "sinks", ()))


@contextlib.contextmanager
def recording(sink):
    """Report every outermost kernel-wrapper call on this thread to
    ``sink.kernel_bytes(name, nbytes)`` for the block."""
    prev = getattr(_local, "sinks", ())
    _local.sinks = prev + (sink,)
    try:
        yield sink
    finally:
        _local.sinks = prev


def reports(name: str, nbytes):
    """Decorator of kernel ``name``'s wrapper: report ``nbytes(*args,
    **kwargs)`` to the recording counters (see the module docstring).
    Only the outermost wrapper call of a nest reports."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            sinks = getattr(_local, "sinks", ())
            if not sinks or current_scope() is not None:
                return fn(*args, **kwargs)
            _local.scope = name
            try:
                out = fn(*args, **kwargs)
                _local.scope = RECKONING
                moved = int(nbytes(*args, **kwargs))
            finally:
                _local.scope = None
            for sink in sinks:
                sink.kernel_bytes(name, moved)
            return out
        return call
    return wrap


# --------------------------------------------------------------------------
# the reckonings
# --------------------------------------------------------------------------

def sector_bytes(word_idx) -> int:
    """Bytes of the distinct 32-byte sectors holding the int32 words at
    flat indices ``word_idx``: what a gather of them must read from HBM."""
    return int(torch.unique(word_idx // 8).numel()) * 32


def rank_packed_bytes(fused, blk, c, cut, sigma: int, bits: int) -> int:
    """Bytes a batch of packed rank queries must move: the checkpoint of
    c and the packed words up to each cutoff's word (their distinct
    sectors), and four int32 words in and out per query."""
    W = fused.shape[1] - sigma
    row0 = blk.long() * (sigma + W)
    w = torch.arange(W, device=fused.device)
    upto = torch.clamp(cut.long() // (32 // bits), max=W - 1)
    packed = (row0[:, None] + sigma + w)[w[None, :] <= upto[:, None]]
    return sector_bytes(torch.cat([row0 + c.long(), packed])) + \
        blk.numel() * 16


def rank_select_bytes(blocks, blk, cut) -> int:
    """Bytes a batch of unpacked in-block counts must move: the symbols
    below each query's cut (their distinct sectors), and four int32 words
    in and out per query."""
    r = blocks.shape[1]
    j = torch.arange(r, device=blocks.device)
    read = (blk.long()[:, None] * r + j)[j[None, :] < cut.long()[:, None]]
    return sector_bytes(read) + blk.numel() * 16


def radix_hist_bytes(n: int, block: int) -> int:
    """The keys read once, one 256-bin int32 row written per tile."""
    return 4 * n + (n // block) * 256 * 4


def radix_pass_bytes(keys, base, operands=(), positions: bool = False) -> int:
    """One stable digit pass: the keys (unless they are one of the
    operands) and the bases read once, each operand read and written once,
    and the positions written when the pass returns them."""
    n = keys.shape[0]
    own = any(o.data_ptr() == keys.data_ptr() for o in operands)
    return (4 * n * (not own) + 4 * base.numel() + 8 * n * len(operands)
            + 4 * n * positions)


def rerank_scan_bytes(r1, r2) -> int:
    """Both rank words read once (one when aliased), the ranks written,
    and the group count."""
    n = r1.shape[0]
    return (8 if r1.data_ptr() == r2.data_ptr() else 12) * n + 4


def char_histogram_bytes(n: int, sigma: int) -> int:
    """The tokens read once, sigma counts written."""
    return 4 * n + 4 * sigma


def query_bytes(fm, P, k: int) -> tuple[int, int]:
    """(bytes, walk steps) of one fused query launch on patterns ``P``,
    replayed in plain PyTorch: the 32-byte sectors of every index word the
    queries need (a rank: its checkpoint word and the block's symbols below
    the cut; an LF step: also the symbol at the cut; a walk step: the mark
    word and its rank; a marked row: its value), plus the patterns, C and
    the outputs; and the walk's dependent steps (iterations with a live
    lane)."""
    from ._bits import popcount32, u32
    from .fm_query import interval_step, packed_symbol
    from .rank_select import rank_packed_plain, rank_select_plain

    dev = P.device
    sigma, r = fm.sigma, fm.sample_rate
    B, m = P.shape
    words = {}

    def add(array, idx):
        words.setdefault(array, []).append(idx.long().reshape(-1))

    def occ(c, p, live, symbol_too=False):
        blk = torch.clamp(p // r, max=fm.n_blocks - 1)
        cut = p - blk * r
        lb, lc, lcut = blk[live].long(), c[live].long(), cut[live].long()
        if fm.bits:
            fpw, wid = 32 // fm.bits, fm.fused.shape[1]
            need = lcut // fpw + 1 if symbol_too else (lcut + fpw - 1) // fpw
            w = torch.arange(wid - sigma, device=dev)
            add("fused", lb * wid + lc)
            add("fused", (lb[:, None] * wid + sigma + w)[
                w[None, :] < need[:, None]])
            return rank_packed_plain(fm.fused, blk, c, cut, bits=fm.bits,
                                     sigma=sigma)
        need = lcut + 1 if symbol_too else lcut
        j = torch.arange(r, device=dev)
        add("occ_samples", lb * sigma + lc)
        add("bwt", (lb[:, None] * r + j)[j[None, :] < need[:, None]])
        return fm.occ_samples[blk.long(), c.long()] + rank_select_plain(
            fm.bwt.view(fm.n_blocks, r), blk, c, cut)

    sp = torch.zeros(B, dtype=torch.int32, device=dev)
    ep = torch.full((B,), fm.length, dtype=torch.int32, device=dev)
    for j in range(m - 1, -1, -1):
        c = P[:, j].contiguous()
        live = (c >= 1) & (c < sigma) & (ep > sp)
        sp, ep = interval_step(c, sp, ep, sigma, lambda cs, p: (
            fm.c_array[cs.long()] + occ(cs, p, live)))
    walk = 0
    if k:
        rows = sp[:, None] + torch.arange(k, dtype=torch.int32,
                                          device=dev)[None, :]
        valid = (rows < ep[:, None]).reshape(-1)
        rows = torch.where(valid, rows.reshape(-1), 0)
        done = ~valid
        for _ in range(fm.sa_sample_rate):
            live = ~done
            if not bool(live.any()):
                break
            walk += 1
            w = (rows // 32).long()
            add("sa_marks", w[live])
            add("sa_mark_ranks", w[live])
            word = u32(fm.sa_marks[w])
            b = (rows % 32).to(torch.int64)
            marked = ((word >> b) & 1).bool()
            idx = fm.sa_mark_ranks[w].long() + popcount32(
                word & ((torch.ones_like(b) << b) - 1))
            hit = idx[live & marked]
            if fm.sa_val_bits:
                bp = hit * fm.sa_val_bits
                add("sa_vals", torch.cat([bp // 32,
                                          (bp + fm.sa_val_bits - 1) // 32]))
            else:
                add("sa_vals", hit)
            sym = (packed_symbol(fm.fused, rows // r, rows % r, sigma=sigma,
                                 bits=fm.bits) if fm.bits
                   else fm.bwt[rows.long()])
            nxt = fm.c_array[sym.long()] + occ(sym, rows, live & ~marked,
                                               symbol_too=True)
            done = done | marked
            rows = torch.where(done, rows, nxt)
    nbytes = sum(sector_bytes(torch.cat(v)) for v in words.values())
    return nbytes + 4 * (P.numel() + sigma + 2 * B + B * k), walk


def segment_view(st, s: int):
    """Segment ``s`` of a stacked bucket as an FM index of its own (the
    fields ``query_bytes`` and the single-index plain versions read):
    views of its rows, checkpoints, C row and SA sample (raw values)."""
    NB, nb = st.blocks_pad, int(st.n_blocks[s])
    S = st.seg_pad
    MW = st.sa_marks.shape[0] // S if st.sa_marks is not None else 0
    MV = st.sa_vals.shape[0] // S if st.sa_vals is not None else 0
    sample = {}
    if st.sa_sample_rate:
        sample = dict(sa_marks=st.sa_marks[s * MW: (s + 1) * MW],
                      sa_mark_ranks=st.sa_mark_ranks[s * MW: (s + 1) * MW],
                      sa_vals=st.sa_vals[s * MV: (s + 1) * MV])
    return types.SimpleNamespace(
        sigma=st.sigma, sample_rate=st.sample_rate, n_blocks=nb,
        length=int(st.lengths[s]), bits=st.bits, c_array=st.c_array[s],
        fused=None if st.fused is None else st.fused[s * NB: s * NB + nb],
        bwt=(None if st.blocks is None
             else st.blocks[s * NB: s * NB + nb].reshape(-1)),
        occ_samples=None if st.occ is None else st.occ[s, :nb],
        sa_val_bits=0, sa_sample_rate=st.sa_sample_rate, device=st.device,
        **sample)


def stacked_query_bytes(st, P, k: int) -> tuple[int, int]:
    """(bytes, walk steps) of one stacked query launch on patterns ``P``:
    ``query_bytes`` of each real segment (its own rows, checkpoints and SA
    sample; segments own disjoint, sector-aligned slices), the patterns
    counted once, and the pad segments' output rows; the walk steps are
    the largest segment's."""
    total, walk = 0, 0
    for s in range(st.n_seg):
        nbytes, w = query_bytes(segment_view(st, s), P, k)
        total += nbytes - (4 * P.numel() if s else 0)
        walk = max(walk, w)
    B = P.shape[0]
    return total + 4 * (st.seg_pad - st.n_seg) * (2 * B + B * k), walk


def walk_bytes(steps: int, *tensors) -> int:
    """A merge walk: one 32-byte sector per dependent step (the rank of
    its row) and the walk's own inputs and outputs (``tensors``) once."""
    return 32 * steps + sum(t.nbytes for t in tensors)
