"""FM-index over a BWT: C array, Occ checkpoints, backward search, locate.

Layout (dense int32 tensors on one device, the same arrays as the JAX
package's ``FMIndex``, so the two can be compared field by field):

* ``bwt``          int32[n_blocks * r]  last column, PAD beyond position n
* ``C``            int32[sigma]  # chars strictly smaller (exclusive cumsum)
* ``occ_samples``  int32[n_blocks + 1, sigma]  checkpointed exclusive Occ
* ``fused``        int32[n_blocks, sigma + r/fpw]  (small alphabets only)
  per-block [Occ checkpoint | bit-packed words], what the packed rank and
  query kernels read (``kernels/rank_select.py``, ``kernels/fm_query.py``)
* ``sa_marks/sa_mark_ranks/sa_vals``  SA sample for locate(): rows whose SA
  value is a multiple of ``sa_sample_rate`` are marked in a bitvector (with
  per-word popcount checkpoints) and their values stored in row order,
  optionally bit-packed as ``val // s`` at ``sa_val_bits`` bits.

rank(c, p) = occ_samples[p // r, c] + count of c in bwt[(p//r)*r : p].
count/locate answer a whole batch through one fused query kernel per call
(``kernels/fm_query``), ``occ_batch`` one batch of rank queries; they and
the symbol counts of ``C`` go through ``kernels/ops`` (CUDA kernels for
CUDA tensors, plain versions for CPU tensors).  The build is onehot-free:
block counts come from one ``bincount`` over ``block * sigma + symbol``
instead of an n x sigma one-hot, with bit-identical output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from ..kernels._bits import i32, popcount32
from ..kernels.fm_query import (  # noqa: F401  (sample_lookup re-exported)
    PAD,
    interval_step,
    packed_symbol,
    sample_lookup,
    unpack_sa_value,
)
from ..kernels.rank_select import pack_words, packed_bits


@dataclasses.dataclass(frozen=True)
class FMIndex:
    bwt: torch.Tensor            # int32[n_blocks * r], PAD beyond position n
    row: torch.Tensor            # int32 scalar: row of the original string
    c_array: torch.Tensor        # int32[sigma]
    occ_samples: torch.Tensor    # int32[n_blocks + 1, sigma]
    fused: torch.Tensor | None   # int32[n_blocks, sigma + W] packed layout
    sa_marks: torch.Tensor | None       # int32[ceil(n/32)] bitvector
    sa_mark_ranks: torch.Tensor | None  # int32[ceil(n/32)] excl. popcounts
    sa_vals: torch.Tensor | None        # int32[#marked] SA values, row order
                                        # (or packed words when sa_val_bits)
    sample_rate: int
    sigma: int
    length: int                  # true text length n
    bits: int                    # packed field width (0 = unpacked)
    sa_sample_rate: int          # SA sampling stride (0 = no locate)
    sa_val_bits: int = 0         # bits per packed SA value (0 = raw)

    @property
    def n(self) -> int:
        return self.length

    @property
    def n_blocks(self) -> int:
        return self.occ_samples.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.bwt.device


def pack_sa_values(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Bit-pack values ``q`` (each < 2^bits, bits < 32) LSB-first into a
    contiguous int32 bitstream; value i occupies bits [i*bits, (i+1)*bits).
    One trailing guard word keeps the two-word decode in bounds.

    Values occupy disjoint bit ranges, so summing their shifted halves into
    the words (``index_add_``) equals OR-ing them, in any order."""
    q = q.to(torch.int64)
    n = q.shape[0]
    bitpos = torch.arange(n, dtype=torch.int64, device=q.device) * bits
    w = bitpos >> 5
    lo = q << (bitpos & 31)              # spans <= 2 consecutive words
    nwords = -(-(n * bits) // 32) + 1    # ceil + guard word
    words = torch.zeros(nwords, dtype=torch.int64, device=q.device)
    words.index_add_(0, w, lo & 0xFFFFFFFF)
    words.index_add_(0, w + 1, lo >> 32)
    return i32(words)


def sample_arrays_from_rows(rows: torch.Tensor, vals: torch.Tensor, n: int,
                            sa_sample_rate: int, *,
                            compress: bool | None = None):
    """(marks, mark_ranks, vals, val_bits) from an explicit marked-row set
    (sorted ``rows`` and their SA values), on the rows' device."""
    dev = rows.device
    rows = rows.to(torch.int64)
    nwords = -(-n // 32)
    words = torch.zeros(nwords, dtype=torch.int64, device=dev)
    # distinct rows set distinct bits, so the sum is the OR
    words.index_add_(0, rows // 32, torch.ones_like(rows) << (rows % 32))
    pc = popcount32(words)
    ranks = (torch.cumsum(pc, 0) - pc).to(torch.int32)
    q = vals.to(torch.int64) // sa_sample_rate   # exact: marked multiples
    val_bits = max(1, int(q.max()).bit_length()) if q.numel() else 0
    if compress is None:
        compress = 0 < val_bits < 32
    if compress and not 0 < val_bits < 32:
        raise ValueError(f"cannot compress SA sample (val_bits={val_bits})")
    if not compress:
        val_bits = 0
    out_vals = pack_sa_values(q, val_bits) if compress else vals.to(
        torch.int32)
    return i32(words), ranks, out_vals, val_bits


def build_sa_samples(sa: torch.Tensor, sa_sample_rate: int, *,
                     compress: bool | None = None):
    """(marks, mark_ranks, vals, val_bits) for locate(), on the SA's
    device: rows i with SA[i] % s == 0 are marked and their values stored
    in row order; ``compress`` bit-packs them (None: whenever smaller)."""
    marked = torch.remainder(sa, sa_sample_rate) == 0
    rows = torch.nonzero(marked).flatten()   # SA holds 0: never empty
    return sample_arrays_from_rows(rows, sa[rows], sa.shape[0],
                                   sa_sample_rate, compress=compress)


def sa_values(fm: FMIndex) -> torch.Tensor:
    """Raw int32 SA-sample values of an index in row order, on its device,
    undoing the optional bit-packing.  The sampled values are exactly
    {0, s, 2s, ...} below the text length, so the count is implied."""
    nvals = -(-fm.length // fm.sa_sample_rate)
    if fm.sa_val_bits:
        idx = torch.arange(nvals, dtype=torch.int32, device=fm.device)
        return (unpack_sa_value(fm.sa_vals, idx, fm.sa_val_bits)
                * fm.sa_sample_rate)
    return fm.sa_vals[:nvals]


def decode_sa_values(fm: FMIndex) -> np.ndarray:
    """``sa_values`` as host numpy."""
    return sa_values(fm).cpu().numpy()


def sample_marked_rows(fm: FMIndex) -> torch.Tensor:
    """Sorted int64 row indices carrying an SA sample, on the index's
    device: the set bits of the ``sa_marks`` bitvector below the text
    length."""
    # an arithmetic shift of the int32 words still brings bit b to bit 0
    bit = torch.arange(32, dtype=torch.int32, device=fm.device)
    bits = ((fm.sa_marks[:, None] >> bit) & 1).reshape(-1)[: fm.length]
    return torch.nonzero(bits).flatten()


FM_ARRAY_FIELDS = ("bwt", "row", "c_array", "occ_samples", "fused",
                   "sa_marks", "sa_mark_ranks", "sa_vals")
FM_AUX_FIELDS = ("sample_rate", "sigma", "length", "bits",
                 "sa_sample_rate", "sa_val_bits")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fm_mismatch(a, b) -> list:
    """Field names on which two FM-indexes differ (empty = bit-identical).
    Either side may be this package's ``FMIndex`` or any object with the
    same fields holding numpy-convertible arrays (e.g. the JAX package's)."""
    out = [name for name in FM_AUX_FIELDS
           if getattr(a, name) != getattr(b, name)]
    for name in FM_ARRAY_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None):
            out.append(name)
        elif x is not None and not np.array_equal(_host(x), _host(y)):
            out.append(name)
    return out


def occ_checkpoints(bwt_arr: torch.Tensor, sigma: int,
                    sample_rate: int) -> torch.Tensor:
    """Exclusive Occ checkpoints int32[n_blocks + 1, sigma]: row k counts
    each symbol in ``bwt_arr[: k * sample_rate]`` (the last row, the
    totals, also when the last block is partial)."""
    dev = bwt_arr.device
    n = bwt_arr.shape[0]
    n_blocks = -(-n // sample_rate)  # ceil
    # block counts without an n x sigma one-hot: one bincount over
    # (block, symbol) cells; int32 keys while they fit
    kdt = torch.int32 if n_blocks * sigma < (1 << 31) else torch.int64
    cell = (torch.arange(n, dtype=kdt, device=dev) // sample_rate) * sigma
    cell += bwt_arr.to(kdt)
    block_counts = torch.bincount(cell, minlength=n_blocks * sigma)
    del cell
    # running counts per symbol down the blocks as ONE 1-D scan over the
    # symbol-major layout, restarted per symbol by subtracting the previous
    # symbol's total (a dim-0 cumsum of the (n_blocks, sigma) matrix runs
    # an outer-dimension scan kernel that is far slower on the GPU)
    run = torch.cumsum(block_counts.view(n_blocks, sigma).t().reshape(-1), 0)
    run = run.view(sigma, n_blocks)
    restart = torch.cat([run.new_zeros(1), run[:-1, -1]])
    occ_samples = torch.zeros((n_blocks + 1, sigma), dtype=torch.int32,
                              device=dev)
    occ_samples[1:] = (run - restart[:, None]).t()
    return occ_samples


def build_fm_index(
    bwt_arr: torch.Tensor, row, sigma: int, sample_rate: int = 64, *,
    sa: torch.Tensor | None = None, sa_sample_rate: int = 32,
    pack: bool | None = None, compress_sa: bool | None = None,
    sa_samples: tuple | None = None,
) -> FMIndex:
    """Build the query index from a BWT on its device.

    ``bwt_arr`` int32[n] (tokens in [0, sigma)), ``row`` the BWT row of the
    original string, ``sample_rate`` the Occ checkpoint spacing r.
    ``pack=None`` bit-packs whenever the alphabet fits; ``pack=False``
    forces the unpacked layout.  ``sa`` enables ``locate`` via SA sampling;
    ``sa_samples`` = (marks, mark_ranks, vals, val_bits) injects prebuilt
    sample arrays instead.
    """
    dev = bwt_arr.device
    n = bwt_arr.shape[0]
    counts = ops.char_histogram(bwt_arr, sigma)
    c_array = (torch.cumsum(counts, 0) - counts).to(torch.int32)

    n_blocks = -(-n // sample_rate)  # ceil
    pad = n_blocks * sample_rate - n
    padded = torch.cat([bwt_arr, torch.full((pad,), PAD, dtype=torch.int32,
                                            device=dev)])
    occ_samples = occ_checkpoints(bwt_arr, sigma, sample_rate)

    bits = 0 if pack is False else packed_bits(sigma, sample_rate)
    if pack and not bits:
        raise ValueError(
            f"cannot pack sigma={sigma} at sample_rate={sample_rate}"
        )
    fused = None
    if bits:
        words = pack_words(padded, bits).view(n_blocks, -1)
        fused = torch.cat([occ_samples[:-1], words], dim=1)

    if sa_samples is not None:
        sa_marks, sa_mark_ranks, sa_vals, sa_val_bits = sa_samples
    elif sa is not None:
        sa_marks, sa_mark_ranks, sa_vals, sa_val_bits = build_sa_samples(
            sa, sa_sample_rate, compress=compress_sa
        )
    else:
        sa_marks = sa_mark_ranks = sa_vals = None
        sa_sample_rate = sa_val_bits = 0

    row = torch.as_tensor(row, dtype=torch.int32, device=dev)
    return FMIndex(padded, row, c_array, occ_samples, fused, sa_marks,
                   sa_mark_ranks, sa_vals, sample_rate, sigma, n, bits,
                   sa_sample_rate, sa_val_bits)


def occ_batch(index: FMIndex, c: torch.Tensor, p: torch.Tensor):
    """# occurrences of c_i in ``bwt[:p_i]`` (exclusive rank), batched.
    p == n_blocks*r folds into the last block (cutoff r), so checkpoints
    beyond the fused rows are never needed."""
    r = index.sample_rate
    blk = torch.clamp(p // r, max=index.n_blocks - 1)
    cut = p - blk * r
    if index.bits:
        return ops.rank_packed(index.fused, blk, c, cut,
                               bits=index.bits, sigma=index.sigma)
    base = index.occ_samples[blk.long(), c.long()]
    blocks = index.bwt.view(index.n_blocks, r)
    return base + ops.rank_unpacked(blocks, blk, c, cut)


def occ(index: FMIndex, c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Scalar Occ(c, p): int32 scalars in, int32 scalar out, through the
    batched rank path (``occ_batch``, so one rank kernel launch on the
    card)."""
    return occ_batch(index, c[None] if c.ndim == 0 else c,
                     p[None] if p.ndim == 0 else p)[0]


def _fm_query(index: FMIndex, patterns: torch.Tensor, k: int):
    """(sp, ep, positions int32[B, k]) from the fused query kernel of the
    index's layout."""
    if index.bits:
        return ops.fm_query_packed(index, patterns, k)
    return ops.fm_query_unpacked(index, patterns, k)


def backward_search_batch(index: FMIndex, patterns: torch.Tensor):
    """(sp, ep) suffix-array intervals for int32[B, m] PAD-padded
    patterns, right to left: the whole batch in one fused query launch
    (``kernels/fm_query``)."""
    sp, ep, _ = _fm_query(index, patterns, 0)
    return sp, ep


def backward_search(index: FMIndex, pattern):
    """Single-pattern (sp, ep), int32 scalars: one backward-search step a
    pattern position (right to left, PADs skipped), each ranking ``sp``
    and ``ep`` through ``occ_batch`` (two rank kernel launches a position
    on the card, no host readback)."""
    dev = index.device
    pattern = torch.as_tensor(pattern, dtype=torch.int32, device=dev)
    sp = torch.zeros(1, dtype=torch.int32, device=dev)
    ep = torch.full((1,), index.n, dtype=torch.int32, device=dev)

    def rank(c, p):
        return index.c_array[c.long()] + occ_batch(index, c, p)

    for c in pattern.flip(0).reshape(-1, 1):
        sp, ep = interval_step(c, sp, ep, index.sigma, rank)
    return sp[0], ep[0]


def count(index: FMIndex, patterns: torch.Tensor) -> torch.Tensor:
    """Batched exact-match counts: int32[B, m] PAD-padded -> int32[B]."""
    sp, ep = backward_search_batch(index, patterns)
    return torch.clamp(ep - sp, min=0)


def locate(index: FMIndex, patterns: torch.Tensor, k: int):
    """First-k occurrence positions per pattern via the SA sample.

    patterns int32[B, m] PAD-padded.  Returns (positions int32[B, k] sorted
    ascending with ``n`` filling unused slots, counts int32[B] clipped to
    k).  One fused query launch runs the search and LF-walks each of the
    B*k candidate rows (<= sa_sample_rate - 1 steps) to its nearest marked
    row; only the per-row sort and the count clamp stay here."""
    if index.sa_sample_rate == 0:
        raise ValueError("index built without sa= — locate unavailable")
    sp, ep, pos = _fm_query(index, patterns, k)
    counts = torch.clamp(ep - sp, min=0, max=k)
    return torch.sort(pos, dim=1).values, counts


def bwt_symbol(index: FMIndex, rows: torch.Tensor) -> torch.Tensor:
    """bwt[rows] batched: rows int32[B] -> symbols int32[B], decoded from
    the packed words when the index is bit-packed."""
    if not index.bits:
        return index.bwt[rows.long()]
    r = index.sample_rate
    return packed_symbol(index.fused, rows // r, rows % r,
                         sigma=index.sigma, bits=index.bits)


def locate_naive(index: FMIndex, sa: torch.Tensor, pattern) -> torch.Tensor:
    """Occurrence positions via a full SA (test oracle for ``locate``):
    int32[n], the SA values of the pattern's interval sorted, ``n`` after
    them."""
    sp, ep = backward_search(index, pattern)
    rows = torch.arange(index.n, device=sa.device)
    return torch.sort(torch.where((rows >= sp) & (rows < ep), sa,
                                  index.n)).values


def count_naive(text, pattern) -> int:
    """Overlapping substring-count numpy oracle."""
    text, pattern = np.asarray(text), np.asarray(pattern)
    m = len(pattern)
    if m == 0 or m > len(text):
        return 0
    windows = np.lib.stride_tricks.sliding_window_view(text, m)
    return int((windows == pattern).all(axis=1).sum())


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def stack_rank_arrays(fms: list[FMIndex], *, seg_pad: int | None = None,
                      blocks_pad: int | None = None):
    """Bucket-stack the rank-addressable arrays of same-layout indexes on
    their device: ``(fused, blocks, occ, c_mat, nb_vec, blocks_pad)`` with
    segment i owning block rows [i*blocks_pad, i*blocks_pad + n_blocks_i).

    Packed layouts fill ``fused`` (zero rows past a segment's blocks);
    unpacked ones ``blocks`` (PAD-filled) and the flat checkpoints ``occ``
    int32[S*NB, sigma], so both share the ``seg * blocks_pad + blk``
    addressing.  Pad segments get ``nb = 1`` (block ids clamp to 0).
    ``seg_pad`` / ``blocks_pad`` default to powers of two."""
    if not fms:
        raise ValueError("cannot stack an empty run")
    f0 = fms[0]
    sig = (f0.sigma, f0.sample_rate, f0.bits)
    for fm in fms:
        if (fm.sigma, fm.sample_rate, fm.bits) != sig:
            raise ValueError(
                f"mixed layouts {(fm.sigma, fm.sample_rate, fm.bits)} "
                f"!= {sig}"
            )
    sigma, r, bits = sig
    S = seg_pad or _next_pow2(len(fms))
    NB = blocks_pad or _next_pow2(max(fm.n_blocks for fm in fms))
    if S < len(fms) or NB < max(fm.n_blocks for fm in fms):
        raise ValueError("bucket shape smaller than the run")
    dev = f0.device
    fused = blocks = occ = None
    if bits:
        fused = torch.zeros((S * NB, f0.fused.shape[1]), dtype=torch.int32,
                            device=dev)
        for i, fm in enumerate(fms):
            fused[i * NB: i * NB + fm.n_blocks] = fm.fused
    else:
        blocks = torch.full((S * NB, r), PAD, dtype=torch.int32, device=dev)
        occ = torch.zeros((S * NB, sigma), dtype=torch.int32, device=dev)
        for i, fm in enumerate(fms):
            nb = fm.n_blocks
            blocks[i * NB: i * NB + nb] = fm.bwt.view(nb, r)
            occ[i * NB: i * NB + nb] = fm.occ_samples[:-1]
    c_mat = torch.zeros((S, sigma), dtype=torch.int32, device=dev)
    for i, fm in enumerate(fms):
        c_mat[i] = fm.c_array
    nb_vec = torch.tensor([fm.n_blocks for fm in fms] + [1] * (S - len(fms)),
                          dtype=torch.int32, device=dev)
    return fused, blocks, occ, c_mat, nb_vec, NB


# -- segment-parallel stacked queries ----------------------------------------
#
# A SegmentedIndex answers a query by asking every live segment.  The
# stacked layout pads every segment's rows to one bucket shape (power-of-two
# block count) and concatenates them row-wise on the segments' device, so
# the whole catalog answers a served batch in ONE stacked query launch
# (``kernels/fm_query``); each segment's answer is bit-identical to its own
# index's.


@dataclasses.dataclass(frozen=True)
class StackedFMIndex:
    """S per-segment FM-indexes padded to one bucket shape, on one device.

    ``fused`` / ``blocks`` rows of all segments concatenate along axis 0
    (segment s owns rows [s*blocks_pad, s*blocks_pad + n_blocks[s])), so a
    lane carrying a segment id addresses the whole catalog.  ``occ`` is
    int32[S, NB, sigma], contiguous, so the kernels read it as the flat
    [S*NB, sigma] rows of ``stack_rank_arrays``.  Pad segments have length
    0 (their search interval starts empty) and ``n_blocks`` 1; pad blocks
    are never addressed (block ids clamp to the true per-segment count).
    SA-sample values are stored raw (bit-packed streams are decoded at
    stack time) so one lookup serves every segment.

    ``stacked_append`` writes into spare capacity IN PLACE: the returned
    object shares this one's tensors (no reallocation), and this one's
    ``n_seg`` is stale from then on — keep only the returned object.
    """

    fused: torch.Tensor | None    # int32[S*NB, sigma + W]     (packed)
    blocks: torch.Tensor | None   # int32[S*NB, r]             (unpacked)
    occ: torch.Tensor | None      # int32[S, NB, sigma]        (unpacked)
    c_array: torch.Tensor         # int32[S, sigma]
    n_blocks: torch.Tensor        # int32[S] true per-segment block counts
    lengths: torch.Tensor         # int32[S] true per-segment text lengths
    sa_marks: torch.Tensor | None       # int32[S*MW] (segment-major)
    sa_mark_ranks: torch.Tensor | None  # int32[S*MW] per-segment cumsums
    sa_vals: torch.Tensor | None        # int32[S*MV] raw (decoded) values
    n_seg: int          # real segment count (<= seg_pad)
    seg_pad: int        # padded segment count S
    blocks_pad: int     # padded per-segment block count NB
    sample_rate: int
    sigma: int
    bits: int
    sa_sample_rate: int  # 0 = no locate

    @property
    def device(self) -> torch.device:
        return self.c_array.device


def _sample_widths(NB: int, r: int, srate: int) -> tuple[int, int]:
    """(MW, MV): mark words and value slots per segment of the bucket."""
    return -(-(NB * r) // 32), -(-(NB * r) // srate)


def stack_fm_indexes(fms: list[FMIndex], *, seg_pad: int | None = None,
                     blocks_pad: int | None = None) -> StackedFMIndex:
    """Assemble single-device FM-indexes into one stacked bucket layout on
    their device.

    All indexes must agree on (sigma, sample_rate, bits, sa_sample_rate);
    raises ``ValueError`` on a mixed catalog (callers fall back to the
    sequential path).  ``seg_pad`` / ``blocks_pad`` override the
    power-of-two bucket defaults (must be >= the real sizes)."""
    if not fms:
        raise ValueError("cannot stack an empty catalog")
    f0 = fms[0]
    sig = (f0.sigma, f0.sample_rate, f0.bits, f0.sa_sample_rate)
    for fm in fms:
        if not isinstance(fm, FMIndex):
            raise ValueError(f"cannot stack {type(fm).__name__}")
        if (fm.sigma, fm.sample_rate, fm.bits, fm.sa_sample_rate) != sig:
            raise ValueError(
                "mixed segment layouts: "
                f"{(fm.sigma, fm.sample_rate, fm.bits, fm.sa_sample_rate)} "
                f"!= {sig}"
            )
    sigma, r, bits, srate = sig
    S = seg_pad or _next_pow2(len(fms))
    NB = blocks_pad or _next_pow2(max(fm.n_blocks for fm in fms))
    if S < len(fms) or NB < max(fm.n_blocks for fm in fms):
        raise ValueError("bucket shape smaller than the catalog")
    dev = f0.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    fused = blocks = occ = None
    if bits:
        fused = zeros(S * NB, f0.fused.shape[1])
    else:
        blocks = torch.full((S * NB, r), PAD, dtype=torch.int32, device=dev)
        occ = zeros(S, NB, sigma)
    sa_marks = sa_mark_ranks = sa_vals = None
    if srate:
        MW, MV = _sample_widths(NB, r, srate)
        sa_marks, sa_mark_ranks, sa_vals = (zeros(S * MW), zeros(S * MW),
                                            zeros(S * MV))
    st = StackedFMIndex(
        fused, blocks, occ, zeros(S, sigma),
        torch.ones(S, dtype=torch.int32, device=dev),  # pads clamp blk to 0
        zeros(S),                                       # pads: ep == 0
        sa_marks, sa_mark_ranks, sa_vals, 0, S, NB, r, sigma, bits, srate,
    )
    for i, fm in enumerate(fms):
        _write_segment(st, i, _seg_rows(st, fm))
    return dataclasses.replace(st, n_seg=len(fms))


def _stack_check(st: StackedFMIndex, fm: FMIndex) -> None:
    """Raise unless ``fm`` fits the stacked bucket layout (same static
    signature, block count within the bucket, same device)."""
    if not isinstance(fm, FMIndex):
        raise ValueError(f"cannot stack {type(fm).__name__}")
    sig = (st.sigma, st.sample_rate, st.bits, st.sa_sample_rate)
    if (fm.sigma, fm.sample_rate, fm.bits, fm.sa_sample_rate) != sig:
        raise ValueError(
            "segment layout does not match the stacked catalog: "
            f"{(fm.sigma, fm.sample_rate, fm.bits, fm.sa_sample_rate)} "
            f"!= {sig}"
        )
    if fm.n_blocks > st.blocks_pad:
        raise ValueError(
            f"segment blocks {fm.n_blocks} exceed bucket {st.blocks_pad}"
        )
    if fm.device != st.device:
        raise ValueError(f"segment on {fm.device}, catalog on {st.device}")


def _seg_rows(st: StackedFMIndex, fm: FMIndex) -> dict:
    """One segment's per-field row payloads, padded to the bucket shapes:
    the update unit shared by ``stack_fm_indexes``, ``stacked_append`` and
    ``stacked_replace_run``."""
    NB, r, sigma = st.blocks_pad, st.sample_rate, st.sigma
    dev, nb = st.device, fm.n_blocks
    out = {}
    if st.bits:
        rows = torch.zeros((NB, st.fused.shape[1]), dtype=torch.int32,
                           device=dev)
        rows[:nb] = fm.fused
        out["fused"] = rows
    else:
        rows = torch.full((NB, r), PAD, dtype=torch.int32, device=dev)
        rows[:nb] = fm.bwt.view(nb, r)
        out["blocks"] = rows
        occ = torch.zeros((NB, sigma), dtype=torch.int32, device=dev)
        occ[:nb] = fm.occ_samples[:-1]
        out["occ"] = occ
    out["c_array"] = fm.c_array
    out["n_blocks"] = nb
    out["lengths"] = fm.length
    if st.sa_sample_rate:
        MW, MV = _sample_widths(NB, r, st.sa_sample_rate)
        marks = torch.zeros(MW, dtype=torch.int32, device=dev)
        ranks = torch.zeros(MW, dtype=torch.int32, device=dev)
        vals = torch.zeros(MV, dtype=torch.int32, device=dev)
        m = fm.sa_marks.shape[0]
        marks[:m] = fm.sa_marks
        ranks[:m] = fm.sa_mark_ranks
        raw = sa_values(fm)
        vals[: raw.shape[0]] = raw
        out["sa_marks"], out["sa_mark_ranks"], out["sa_vals"] = (
            marks, ranks, vals)
    return out


def _write_segment(st: StackedFMIndex, i: int, rows: dict) -> None:
    """Copy one segment's rows into slot ``i`` of every bucket tensor, in
    place."""
    NB = st.blocks_pad
    for name in ("fused", "blocks"):
        if name in rows:
            getattr(st, name)[i * NB: (i + 1) * NB] = rows[name]
    if "occ" in rows:
        st.occ[i] = rows["occ"]
    st.c_array[i] = rows["c_array"]
    st.n_blocks[i] = rows["n_blocks"]
    st.lengths[i] = rows["lengths"]
    if st.sa_sample_rate:
        MW, MV = _sample_widths(NB, st.sample_rate, st.sa_sample_rate)
        st.sa_marks[i * MW: (i + 1) * MW] = rows["sa_marks"]
        st.sa_mark_ranks[i * MW: (i + 1) * MW] = rows["sa_mark_ranks"]
        st.sa_vals[i * MV: (i + 1) * MV] = rows["sa_vals"]


def stacked_append(st: StackedFMIndex, fm: FMIndex) -> StackedFMIndex:
    """Append one segment into spare bucket capacity, in place.

    Writes the new segment's rows into slot ``n_seg`` of every bucket
    tensor and returns the catalog with ``n_seg`` bumped.  No tensor is
    reallocated (every ``data_ptr()`` stays), so ``st`` itself is stale
    afterwards: keep the returned object only.  Raises ``ValueError``,
    writing nothing, when the bucket is full or the segment does not fit;
    callers re-stack."""
    _stack_check(st, fm)
    i = st.n_seg
    if i >= st.seg_pad:
        raise ValueError(f"stacked catalog full ({i} == seg_pad)")
    _write_segment(st, i, _seg_rows(st, fm))
    return dataclasses.replace(st, n_seg=i + 1)


def stacked_replace_run(st: StackedFMIndex, start: int, count: int,
                        fm: FMIndex) -> StackedFMIndex:
    """Replace segments [start, start+count) with one merged segment.

    The incremental stacked-catalog update after a compaction: later
    segments shift left on the device through concatenations of the
    existing slices (new tensors: overlapping in-place moves are refused
    by torch), bucket shapes stay fixed.  ``st`` stays valid.  Raises
    ``ValueError`` when the merged segment does not fit the bucket."""
    _stack_check(st, fm)
    n = st.n_seg
    if not (0 <= start and count >= 1 and start + count <= n):
        raise ValueError(f"bad run [{start}, {start + count}) of {n}")
    rows = _seg_rows(st, fm)
    S, NB = st.seg_pad, st.blocks_pad

    def splice(arr, unit, new_rows, fill):
        head = arr[: start * unit]
        tail = arr[(start + count) * unit: n * unit]
        new_rows = torch.as_tensor(new_rows, dtype=arr.dtype,
                                   device=arr.device).reshape(
            (-1,) + arr.shape[1:])
        npad = S * unit - head.shape[0] - new_rows.shape[0] - tail.shape[0]
        pad = torch.full((npad,) + arr.shape[1:], fill, dtype=arr.dtype,
                         device=arr.device)
        return torch.cat([head, new_rows, tail, pad])

    rep = {"n_seg": n - count + 1}
    if st.bits:
        rep["fused"] = splice(st.fused, NB, rows["fused"], 0)
    else:
        rep["blocks"] = splice(st.blocks, NB, rows["blocks"], PAD)
        rep["occ"] = splice(st.occ, 1, rows["occ"], 0)
    rep["c_array"] = splice(st.c_array, 1, rows["c_array"], 0)
    # pad segments clamp blk to 0 and start with ep == 0 (stack invariant)
    rep["n_blocks"] = splice(st.n_blocks, 1, rows["n_blocks"], 1)
    rep["lengths"] = splice(st.lengths, 1, rows["lengths"], 0)
    if st.sa_sample_rate:
        MW, MV = _sample_widths(NB, st.sample_rate, st.sa_sample_rate)
        rep["sa_marks"] = splice(st.sa_marks, MW, rows["sa_marks"], 0)
        rep["sa_mark_ranks"] = splice(st.sa_mark_ranks, MW,
                                      rows["sa_mark_ranks"], 0)
        rep["sa_vals"] = splice(st.sa_vals, MV, rows["sa_vals"], 0)
    return dataclasses.replace(st, **rep)


def _stacked_query(st: StackedFMIndex, patterns: torch.Tensor, k: int):
    """(sp, ep int32[S, B], positions int32[S, B, k]) from the stacked
    query kernel of the catalog's layout."""
    if st.bits:
        return ops.fm_query_stacked_packed(st, patterns, k)
    return ops.fm_query_stacked_unpacked(st, patterns, k)


def count_stacked(st: StackedFMIndex, patterns: torch.Tensor) -> torch.Tensor:
    """Per-segment exact-match counts, int32[S, B] for int32[B, m]
    PAD-padded patterns; row s is bit-identical to ``count`` on segment s
    alone (pad-segment rows are all zero).  One stacked launch."""
    sp, ep, _ = _stacked_query(st, patterns, 0)
    return torch.clamp(ep - sp, min=0)


def locate_stacked(st: StackedFMIndex, patterns: torch.Tensor, k: int):
    """Per-segment first-k locate: (positions int32[S, B, k] segment-local,
    sorted, filled with the segment length; counts int32[S, B] clipped to
    k).  Row s is bit-identical to ``locate`` on segment s alone; the
    caller offsets to global coordinates and merges.  One stacked launch."""
    if st.sa_sample_rate == 0:
        raise ValueError("catalog stacked without SA samples — no locate")
    sp, ep, pos = _stacked_query(st, patterns, k)
    return (torch.sort(pos, dim=2).values,
            torch.clamp(ep - sp, min=0, max=k))
