"""FM-index over a BWT: C array, Occ checkpoints, backward search, locate.

Layout (dense int32 tensors on one device, the same arrays as the JAX
package's ``FMIndex``, so the two can be compared field by field):

* ``bwt``          int32[n_blocks * r]  last column, PAD beyond position n
* ``C``            int32[sigma]  # chars strictly smaller (exclusive cumsum)
* ``occ_samples``  int32[n_blocks + 1, sigma]  checkpointed exclusive Occ
* ``fused``        int32[n_blocks, sigma + r/fpw]  (small alphabets only)
  per-block [Occ checkpoint | bit-packed words], what the packed rank
  kernel reads (``kernels/rank_select.py``)
* ``sa_marks/sa_mark_ranks/sa_vals``  SA sample for locate(): rows whose SA
  value is a multiple of ``sa_sample_rate`` are marked in a bitvector (with
  per-word popcount checkpoints) and their values stored in row order,
  optionally bit-packed as ``val // s`` at ``sa_val_bits`` bits.

rank(c, p) = occ_samples[p // r, c] + count of c in bwt[(p//r)*r : p].
All rank queries and the symbol counts of ``C`` go through ``kernels/ops``
(CUDA kernels for CUDA tensors, plain versions for CPU tensors).  The
build is onehot-free: block counts come from one ``bincount`` over
``block * sigma + symbol`` instead of an n x sigma one-hot, with
bit-identical output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from ..kernels._bits import i32, popcount32, u32
from ..kernels.rank_select import pack_words, packed_bits

PAD = -1  # query padding token


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


def unpack_sa_value(words: torch.Tensor, idx: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Decode packed value ``idx`` from a ``pack_sa_values`` bitstream
    (out-of-range idx of garbage lanes clamp in bounds and decode
    garbage, like the raw ``vals[clip(idx)]`` path)."""
    # idx * bits can overflow int32 at corpus scale; split the product
    base = (idx // 32) * bits
    rem = (idx % 32) * bits
    w = torch.clamp(base + rem // 32, 0, words.shape[0] - 2).long()
    off = (rem % 32).to(torch.int64)
    lo = u32(words[w]) >> off
    hi = torch.where(off > 0, (u32(words[w + 1]) << ((32 - off) & 31))
                     & 0xFFFFFFFF, 0)
    return ((lo | hi) & ((1 << bits) - 1)).to(torch.int32)


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


def decode_sa_values(fm: FMIndex) -> np.ndarray:
    """Raw SA-sample values of an index in row order (host numpy),
    undoing the optional bit-packing."""
    nvals = -(-fm.length // fm.sa_sample_rate)
    if fm.sa_val_bits:
        idx = torch.arange(nvals, dtype=torch.int32, device=fm.device)
        return (unpack_sa_value(fm.sa_vals, idx, fm.sa_val_bits)
                * fm.sa_sample_rate).cpu().numpy()
    return fm.sa_vals[:nvals].cpu().numpy()


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
    # exclusive checkpoints: occ_samples[k] counts bwt[: k*r]

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


def _interval_step(c, sp, ep, sigma: int, rank):
    """One backward-search transition.  ``rank(c_safe, p)`` maps a
    symbol/position pair to ``C[c] + Occ(c, p)``.  PAD steps are no-ops;
    an empty interval stays empty; an out-of-alphabet symbol empties it."""
    in_alphabet = (c >= 1) & (c < sigma)
    valid = in_alphabet & (ep > sp)
    c_safe = torch.where(in_alphabet, c, 0)
    nsp = rank(c_safe, sp)
    nep = rank(c_safe, ep)
    return (
        torch.where(valid, nsp, sp),
        torch.where(valid, nep,
                    torch.where((c != PAD) & ~in_alphabet, sp, ep)),
    )


def backward_search_batch(index: FMIndex, patterns: torch.Tensor):
    """(sp, ep) suffix-array intervals for int32[B, m] PAD-padded
    patterns, right to left (PADs sit on the right, so they come first and
    are skipped).  Each step issues one batched rank call per interval end,
    so the whole batch shares kernel launches."""
    B, m = patterns.shape

    def rank(c, p):
        return index.c_array[c.long()] + occ_batch(index, c, p)

    sp = torch.zeros(B, dtype=torch.int32, device=patterns.device)
    ep = torch.full((B,), index.n, dtype=torch.int32, device=patterns.device)
    for j in range(m - 1, -1, -1):
        sp, ep = _interval_step(patterns[:, j].contiguous(), sp, ep,
                                index.sigma, rank)
    return sp, ep


def count(index: FMIndex, patterns: torch.Tensor) -> torch.Tensor:
    """Batched exact-match counts: int32[B, m] PAD-padded -> int32[B]."""
    sp, ep = backward_search_batch(index, patterns)
    return torch.clamp(ep - sp, min=0)


def sample_lookup(marks, mark_ranks, vals, rows, *, val_bits: int = 0,
                  val_scale: int = 1, idx_offset=0):
    """(marked, value) of the SA sample at each row (value garbage when
    unmarked); ``val_bits`` > 0 decodes the bit-packed value stream."""
    w = (rows // 32).long()
    b = (rows % 32).to(torch.int64)
    word = u32(marks[w])
    marked = ((word >> b) & 1).bool()
    below = popcount32(word & ((torch.ones_like(b) << b) - 1))
    idx = mark_ranks[w] + below.to(torch.int32) + idx_offset
    if val_bits:
        val = unpack_sa_value(vals, idx, val_bits) * val_scale
    else:
        val = vals[torch.clamp(idx, 0, vals.shape[0] - 1).long()]
    return marked, val


def _sample_lookup(index: FMIndex, rows):
    return sample_lookup(index.sa_marks, index.sa_mark_ranks, index.sa_vals,
                         rows, val_bits=index.sa_val_bits,
                         val_scale=index.sa_sample_rate)


def packed_symbol(fused, blk, j, *, sigma: int, bits: int):
    """Decode symbol ``j`` of fused row ``blk`` from the packed words."""
    fpw = 32 // bits
    word = u32(fused[blk.long(), (sigma + j // fpw).long()])
    sh = ((j % fpw) * bits).to(torch.int64)
    return ((word >> sh) & ((1 << bits) - 1)).to(torch.int32)


def bwt_symbol(index: FMIndex, rows):
    """bwt[rows] batched, extracted from the packed words when bit-packed,
    so the locate walk touches only the compact layout."""
    if not index.bits:
        return index.bwt[rows.long()]
    r = index.sample_rate
    return packed_symbol(index.fused, rows // r, rows % r,
                         sigma=index.sigma, bits=index.bits)


def _locate_walk(n_steps: int, rows, valid, lookup, lf_next):
    """The locate LF-walk: each lane walks ``rows`` toward its nearest
    SA-sampled row; ``lookup(rows)`` -> (marked, sampled value),
    ``lf_next(rows)`` -> LF-mapped rows.  Returns flat positions (garbage
    where ``~valid``)."""
    pos = torch.zeros_like(rows)
    steps = torch.zeros_like(rows)
    done = ~valid
    for _ in range(n_steps):
        marked, val = lookup(rows)
        pos = torch.where(marked & ~done, val + steps, pos)
        done = done | marked
        rows = torch.where(done, rows, lf_next(rows))
        steps = steps + torch.where(done, 0, 1).to(steps.dtype)
    return pos


def locate(index: FMIndex, patterns: torch.Tensor, k: int):
    """First-k occurrence positions per pattern via the SA sample.

    patterns int32[B, m] PAD-padded.  Returns (positions int32[B, k] sorted
    ascending with ``n`` filling unused slots, counts int32[B] clipped to
    k).  Each of the B*k candidate rows LF-walks (<= sa_sample_rate - 1
    steps, each one batched rank call) to its nearest marked row."""
    if index.sa_sample_rate == 0:
        raise ValueError("index built without sa= — locate unavailable")
    sp, ep = backward_search_batch(index, patterns)
    B = sp.shape[0]
    rows = sp[:, None] + torch.arange(k, dtype=torch.int32,
                                      device=sp.device)[None, :]
    valid = (rows < ep[:, None]).reshape(-1)
    rows = torch.where(valid, rows.reshape(-1), 0)

    def lf_next(rows):
        c = bwt_symbol(index, rows)
        return index.c_array[c.long()] + occ_batch(index, c, rows)

    pos = _locate_walk(index.sa_sample_rate, rows, valid,
                       lambda rows: _sample_lookup(index, rows), lf_next)
    out = torch.where(valid, pos, index.n).view(B, k)
    counts = torch.clamp(ep - sp, min=0, max=k)
    return torch.sort(out, dim=1).values, counts
