"""Fused FM-index queries: the backward search of a whole (B, m) batch of
PAD-padded patterns and, for locate, the LF-walk of every candidate row to
its SA sample, in one kernel launch per batch (``csrc/fm_query_packed.cu``
for the fused packed rows, ``csrc/fm_query_unpacked.cu`` for int32 blocks
plus ``occ_samples``).

The JAX package runs the same steps as a ``lax.scan`` (search) and a
``fori_loop`` (walk) over batched rank calls inside one jitted program.
The plain versions here are that step loop in eager PyTorch, one batched
rank call per step: over ``rank_packed_plain`` / ``rank_select_plain`` by
default, or over any function with their signature (``rank=``; passing the
single-batch rank kernels times the port's earlier one-launch-per-step
design).  They call no kernel of their own, on any device.

Each wrapper takes an FM index (``core.fm_index.FMIndex`` or any object
with its fields), int32[B, m] patterns and ``k`` (0 = search only) and
returns ``(sp, ep, positions)``: the suffix-array interval of every pattern
and int32[B, k] unsorted positions, ``n`` in the slots past the pattern's
occurrences.  CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.

The stacked wrappers (``fm_query_stacked_packed`` / ``_unpacked``, one
launch of ``csrc/fm_query_stacked.cu``) take a segment catalog's bucket
(``core.fm_index.StackedFMIndex``) and answer every pattern against every
segment: ``(sp, ep)`` int32[S, B] and positions int32[S, B, k], row s
being segment s's own answer (pad segments: zeros).  The kernel searches
each (segment, pattern) pair once and walks only its live rows (the first
min(ep - sp, k)); the packed entry's blocks hold as few pairs as still
make the launch one resident wave of the card (``stacked_occupancy``,
``stacked_plan``) and share each block's walks among its threads, the
unpacked entry's 8 pairs a block of 16 lanes each.  Their plain versions
are the JAX package's stacked step loops, one batched rank call per step
over the flat segment x batch lanes.
"""

from __future__ import annotations

import torch

from . import _build, traffic
from ._bits import popcount32, u32
from .rank_select import rank_packed_plain, rank_select_plain

PAD = -1  # query padding token


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


def packed_symbol(fused, blk, j, *, sigma: int, bits: int):
    """Decode symbol ``j`` of fused row ``blk`` from the packed words."""
    fpw = 32 // bits
    word = u32(fused[blk.long(), (sigma + j // fpw).long()])
    sh = ((j % fpw) * bits).to(torch.int64)
    return ((word >> sh) & ((1 << bits) - 1)).to(torch.int32)


def interval_step(c, sp, ep, sigma: int, rank):
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


def locate_walk(n_steps: int, rows, valid, lookup, lf_next):
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


def _query_steps(fm, patterns, k: int, occ, symbol):
    """The plain step loop over ``occ(c, p)`` (exclusive rank) and
    ``symbol(rows)`` (bwt[rows])."""
    B, m = patterns.shape

    def rank(c, p):
        return fm.c_array[c.long()] + occ(c, p)

    sp = torch.zeros(B, dtype=torch.int32, device=patterns.device)
    ep = torch.full((B,), fm.length, dtype=torch.int32,
                    device=patterns.device)
    for j in range(m - 1, -1, -1):      # PADs sit on the right: first
        sp, ep = interval_step(patterns[:, j].contiguous(), sp, ep,
                               fm.sigma, rank)
    if not k:
        return sp, ep, sp.new_empty((B, 0))
    rows = sp[:, None] + torch.arange(k, dtype=torch.int32,
                                      device=sp.device)[None, :]
    valid = (rows < ep[:, None]).reshape(-1)
    rows = torch.where(valid, rows.reshape(-1), 0)
    pos = locate_walk(
        fm.sa_sample_rate, rows, valid,
        lambda rows: sample_lookup(fm.sa_marks, fm.sa_mark_ranks, fm.sa_vals,
                                   rows, val_bits=fm.sa_val_bits,
                                   val_scale=fm.sa_sample_rate),
        lambda rows: rank(symbol(rows), rows))
    return sp, ep, torch.where(valid, pos, fm.length).view(B, k)


def _blocks(fm, p):
    """(block, cutoff) of positions p; p = n_blocks*r folds into the last
    block (cutoff r)."""
    r = fm.sample_rate
    blk = torch.clamp(p // r, max=fm.n_blocks - 1)
    return blk, p - blk * r


def fm_query_packed_plain(fm, patterns, k: int = 0, *,
                          rank=rank_packed_plain):
    """The plain version of ``fm_query_packed``: one batched ``rank`` call
    (``rank_packed``'s signature) per interval end and step."""
    def occ(c, p):
        blk, cut = _blocks(fm, p)
        return rank(fm.fused, blk, c, cut, bits=fm.bits, sigma=fm.sigma)

    r = fm.sample_rate
    return _query_steps(fm, patterns, k, occ, lambda rows: packed_symbol(
        fm.fused, rows // r, rows % r, sigma=fm.sigma, bits=fm.bits))


def fm_query_unpacked_plain(fm, patterns, k: int = 0, *,
                            rank=rank_select_plain):
    """The plain version of ``fm_query_unpacked``: the checkpoint gather
    plus one batched ``rank`` call (``rank_select``'s signature) per
    interval end and step."""
    blocks = fm.bwt.view(fm.n_blocks, fm.sample_rate)

    def occ(c, p):
        blk, cut = _blocks(fm, p)
        return (fm.occ_samples[blk.long(), c.long()]
                + rank(blocks, blk, c, cut))

    return _query_steps(fm, patterns, k, occ, lambda rows: fm.bwt[rows.long()])


def _sample_args(fm, k: int, name: str):
    """(tensors, C arguments) of the SA sample a launch reads: marks, mark
    ranks, values, value words, stride, value bits (nothing for k = 0)."""
    if not k:
        return (), (None, None, None, 0, 0, 0)
    if fm.sa_sample_rate == 0 or fm.sa_marks is None:
        raise ValueError(f"{name}: index built without an SA sample")
    tensors = (fm.sa_marks, fm.sa_mark_ranks, fm.sa_vals)
    return tensors, (*(t.data_ptr() for t in tensors), fm.sa_vals.shape[0],
                     fm.sa_sample_rate, fm.sa_val_bits)


def _launch(name, fm, patterns, k, tensors, layout_args, plan_args=()):
    """Check the CUDA arguments, allocate the outputs and launch ``name``
    once for the whole batch (``plan_args``: the C arguments of its launch
    plan, after k)."""
    sample, sample_args = _sample_args(fm, k, name)
    _build.check_cuda(name, *tensors, fm.c_array, *sample, patterns)
    if patterns.dim() != 2 or k < 0:
        raise ValueError(f"{name}: patterns must be int32[B, m], k >= 0")
    B, m = patterns.shape
    dev = patterns.device
    sp = torch.empty(B, dtype=torch.int32, device=dev)
    ep = torch.empty(B, dtype=torch.int32, device=dev)
    pos = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B:
        _build.launch(name, *layout_args, fm.length, fm.c_array.data_ptr(),
                      *sample_args, patterns.data_ptr(), B, m, k,
                      *plan_args, sp.data_ptr(), ep.data_ptr(),
                      pos.data_ptr())
    return sp, ep, pos


@traffic.reports("fm_query_packed",
                 lambda fm, patterns, k=0: traffic.query_bytes(fm, patterns, k)[0])
def fm_query_packed(fm, patterns, k: int = 0):
    """(sp, ep, positions) over the fused packed rows (``fm.bits`` 2 or
    4); the plain version for CPU tensors, one kernel launch otherwise."""
    fused = fm.fused
    if fm.bits not in (2, 4) or fused is None or fm.sigma > 1 << fm.bits:
        raise ValueError(f"fm_query_packed: no packed layout "
                         f"(bits={fm.bits}, sigma={fm.sigma})")
    if _build.on_cpu(fused, fm.c_array, patterns):
        return fm_query_packed_plain(fm, patterns, k)
    return _launch("fm_query_packed", fm, patterns, k, (fused,), (
        fused.data_ptr(), fused.shape[1], fused.shape[0], fm.sigma, fm.bits,
        fm.sample_rate))


UNPACKED_THREADS = 128      # threads a block of fm_query_unpacked.cu
UNPACKED_UNITS = 16         # units a block: groups of 8 lanes
# the C occupancy query's argument types: vec, out
UNPACKED_OCCUPANCY_ARGTYPES = ("c_int", "c_void_p")
_unpacked_occupancy: dict = {}


def unpacked_plan(B: int, k: int, r: int, resident: int,
                  aligned: bool = True) -> dict:
    """The launch of ``fm_query_unpacked.cu`` for ``B`` patterns at ``k``
    over blocks of ``r`` symbols on a card that holds ``resident`` blocks
    of ``UNPACKED_THREADS`` at once.  A unit is a pattern's search (k = 0)
    or one of its k walked rows; a block holds a tile of
    ``UNPACKED_UNITS`` consecutive units, and the grid is a block a tile
    up to one resident wave (blocks stride over the tiles beyond it).
    ``vector``: 16-byte chunk loads, where the BWT starts 16-byte
    ``aligned`` and r % 4 == 0."""
    tiles = -(-B * max(k, 1) // UNPACKED_UNITS)
    return {"grid": max(1, min(tiles, resident)),
            "vector": aligned and r % 4 == 0}


def unpacked_occupancy(device, vector: bool) -> dict:
    """Registers, spilled bytes and resident blocks per SM of
    ``fm_query_unpacked.cu``'s kernel of 16- or 4-byte loads
    (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), with the card's
    SMs and the blocks it holds at once (``resident``); asked once per
    kernel and card."""
    import ctypes

    dev = torch.device(device)
    key = (dev.index, vector)
    if key not in _unpacked_occupancy:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = _build.query(
                "fm_query_unpacked", "fm_query_unpacked_occupancy",
                [getattr(ctypes, t) for t in UNPACKED_OCCUPANCY_ARGTYPES],
                int(vector), out)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if err:
            raise RuntimeError(f"fm_query_unpacked_occupancy failed: CUDA "
                               f"error {err}")
        occ = dict(zip(("blocks_per_sm", "registers", "threads",
                        "local_bytes"), list(out)), sms=sms)
        occ["resident"] = occ["blocks_per_sm"] * sms
        _unpacked_occupancy[key] = occ
    return _unpacked_occupancy[key]


def unpacked_launch_plan(fm, B: int, k: int) -> dict:
    """``unpacked_plan`` of a launch over ``fm``'s blocks on their card,
    its wave read from the occupancy of the kernel it launches."""
    r, aligned = fm.sample_rate, fm.bwt.data_ptr() % 16 == 0
    resident = unpacked_occupancy(fm.bwt.device,
                                  aligned and r % 4 == 0)["resident"]
    return unpacked_plan(B, k, r, resident, aligned)


@traffic.reports("fm_query_unpacked",
                 lambda fm, patterns, k=0: traffic.query_bytes(fm, patterns, k)[0])
def fm_query_unpacked(fm, patterns, k: int = 0):
    """(sp, ep, positions) over int32 blocks plus ``occ_samples``; the
    plain version for CPU tensors, one kernel launch otherwise
    (``unpacked_launch_plan``)."""
    name = "fm_query_unpacked"
    if _build.on_cpu(fm.bwt, fm.occ_samples, fm.c_array, patterns):
        return fm_query_unpacked_plain(fm, patterns, k)
    _build.check_cuda(name, fm.bwt, patterns)
    plan = unpacked_launch_plan(fm, len(patterns), k)
    return _launch(name, fm, patterns, k, (fm.bwt, fm.occ_samples), (
        fm.bwt.data_ptr(), fm.occ_samples.data_ptr(), fm.n_blocks, fm.sigma,
        fm.sample_rate), (int(plan["vector"]), plan["grid"]))


# -- the stacked catalog: every pattern against every segment ---------------

def _stacked_steps(st, patterns, k: int, occ, symbol):
    """The plain stacked step loop over ``occ(seg, c, p)`` (exclusive rank
    inside segment ``seg``) and ``symbol(seg, rows)``, on flat lanes
    ``seg * B + b`` (search) and ``(seg * B + b) * k + j`` (walk), every
    bucket segment included."""
    S, (B, m) = st.seg_pad, patterns.shape
    dev = patterns.device
    seg = torch.arange(S, device=dev).repeat_interleave(B)

    def rank(c, p):
        return st.c_array[seg, c.long()] + occ(seg, c, p)

    sp = torch.zeros(S * B, dtype=torch.int32, device=dev)
    ep = st.lengths.repeat_interleave(B)
    for j in range(m - 1, -1, -1):      # PADs sit on the right: first
        sp, ep = interval_step(patterns[:, j].repeat(S), sp, ep, st.sigma,
                               rank)
    if not k:
        return sp.view(S, B), ep.view(S, B), sp.new_empty((S, B, 0))
    seg = torch.arange(S, device=dev).repeat_interleave(B * k)
    rows = sp[:, None] + torch.arange(k, dtype=torch.int32,
                                      device=dev)[None, :]
    valid = (rows < ep[:, None]).reshape(-1)
    rows = torch.where(valid, rows.reshape(-1), 0)
    # per-segment SA-sample strides in the flat (segment-major) arrays:
    # pseudo-row seg*MW*32 + row lands on segment seg's mark words, and
    # idx_offset shifts into its slice of the value stream (int64: the
    # products pass 2^31 at catalog scale)
    MW = st.sa_marks.shape[0] // S
    MV = st.sa_vals.shape[0] // S

    def lookup(rows):
        return sample_lookup(st.sa_marks, st.sa_mark_ranks, st.sa_vals,
                             seg * (MW * 32) + rows, idx_offset=seg * MV)

    def lf_next(rows):
        c = symbol(seg, rows)
        return st.c_array[seg, c.long()] + occ(seg, c, rows)

    pos = locate_walk(st.sa_sample_rate, rows, valid, lookup, lf_next)
    fill = st.lengths.repeat_interleave(B * k)
    return (sp.view(S, B), ep.view(S, B),
            torch.where(valid, pos, fill).view(S, B, k))


def _stacked_blocks(st, seg, p):
    """(bucket row, cutoff) of positions p inside segments seg; block ids
    clamp to each segment's true block count."""
    r = st.sample_rate
    blk = torch.minimum(p // r, st.n_blocks[seg] - 1)
    return seg * st.blocks_pad + blk, blk, p - blk * r


def fm_query_stacked_packed_plain(st, patterns, k: int = 0):
    """The plain version of ``fm_query_stacked_packed``: one batched
    ``rank_packed_plain`` call per interval end and step over all lanes."""
    r = st.sample_rate

    def occ(seg, c, p):
        row, _, cut = _stacked_blocks(st, seg, p)
        return rank_packed_plain(st.fused, row, c, cut, bits=st.bits,
                                 sigma=st.sigma)

    def symbol(seg, rows):
        return packed_symbol(st.fused, seg * st.blocks_pad + rows // r,
                             rows % r, sigma=st.sigma, bits=st.bits)

    return _stacked_steps(st, patterns, k, occ, symbol)


def fm_query_stacked_unpacked_plain(st, patterns, k: int = 0):
    """The plain version of ``fm_query_stacked_unpacked``: the checkpoint
    gather plus one batched ``rank_select_plain`` call per interval end and
    step over all lanes."""
    r = st.sample_rate

    def occ(seg, c, p):
        row, blk, cut = _stacked_blocks(st, seg, p)
        return (st.occ[seg, blk.long(), c.long()]
                + rank_select_plain(st.blocks, row, c, cut))

    def symbol(seg, rows):
        return st.blocks[(seg * st.blocks_pad + rows // r).long(),
                         (rows % r).long()]

    return _stacked_steps(st, patterns, k, occ, symbol)


def stacked_launch_args(name, st, patterns, k: int):
    """Check the CUDA arguments of stacked kernel ``name`` (the bucket's
    layout) and allocate its [S, B] / [S, B, k] outputs; returns the
    outputs ``(sp, ep, positions)`` and the C arguments up to ``k``: the
    layout, the bucket's strides and per-segment vectors, the SA sample,
    the patterns, B, m and k."""
    if st.bits:
        tensors = (st.fused,)
        layout = (st.fused.data_ptr(), st.fused.shape[1], st.blocks_pad,
                  st.sigma, st.bits, st.sample_rate)
    else:
        tensors = (st.blocks, st.occ)
        layout = (st.blocks.data_ptr(), st.occ.data_ptr(), st.blocks_pad,
                  st.sigma, st.sample_rate)
    sample, MW, MV = (), 0, 0
    if k:
        if st.sa_sample_rate == 0 or st.sa_marks is None:
            raise ValueError(f"{name}: catalog stacked without SA samples")
        sample = (st.sa_marks, st.sa_mark_ranks, st.sa_vals)
        MW = st.sa_marks.shape[0] // st.seg_pad
        MV = st.sa_vals.shape[0] // st.seg_pad
    _build.check_cuda(name, *tensors, st.n_blocks, st.lengths, st.c_array,
                      *sample, patterns)
    if patterns.dim() != 2 or k < 0:
        raise ValueError(f"{name}: patterns must be int32[B, m], k >= 0")
    S, (B, m) = st.seg_pad, patterns.shape
    dev = patterns.device
    out = (torch.empty((S, B), dtype=torch.int32, device=dev),
           torch.empty((S, B), dtype=torch.int32, device=dev),
           torch.empty((S, B, k), dtype=torch.int32, device=dev))
    ptrs = [t.data_ptr() for t in sample] or [None] * 3
    return out, (*layout, st.n_seg, S, st.n_blocks.data_ptr(),
                 st.lengths.data_ptr(), st.c_array.data_ptr(), *ptrs, MW, MV,
                 st.sa_sample_rate if k else 0, patterns.data_ptr(), B, m, k)


STACKED_THREADS = 128   # threads a block of the stacked kernels
STACKED_GROUP = 16      # unpacked: lanes that search one pair together
# the C occupancy query's argument types: unpacked, bits, sigma, out
OCCUPANCY_ARGTYPES = ("c_int", "c_int", "c_int", "c_void_p")
_occupancy: dict = {}


def stacked_occupancy(st) -> dict:
    """Registers, spilled bytes and resident blocks per SM of the bucket's
    stacked kernel on its card (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), with the card's
    SMs; asked once per kernel and card."""
    import ctypes

    dev = st.c_array.device
    key = (dev.index, st.bits, st.sigma)
    if key not in _occupancy:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = _build.query(
                "fm_query_stacked_packed", "fm_query_stacked_occupancy",
                [getattr(ctypes, t) for t in OCCUPANCY_ARGTYPES],
                0 if st.bits else 1, st.bits or 4, st.sigma, out)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if err:
            raise RuntimeError(f"fm_query_stacked_occupancy failed: CUDA "
                               f"error {err}")
        _occupancy[key] = dict(zip(("blocks_per_sm", "registers", "threads",
                                    "local_bytes"), list(out)), sms=sms)
    return _occupancy[key]


def stacked_plan(B: int, n_seg: int, resident: int) -> int:
    """Pairs (segment, pattern) a block of a packed stacked launch, whose
    grid is a block for each ``tile`` pairs of each segment: the fewest
    whose real segments' blocks fit the ``resident`` blocks the card holds
    at once, so that the launch is one resident wave spread over the most
    blocks (the pairs' searches over the most SMs, the most threads for
    their walks); 128 (a lane a pair) when none does.  ceil(B / tile)
    blocks a segment fit ``resident // n_seg`` just when tile >= B over
    it."""
    per_seg = resident // n_seg
    return min(-(-B // per_seg), STACKED_THREADS) if per_seg else \
        STACKED_THREADS


def stacked_grid(B: int, seg_pad: int, tile: int) -> int:
    """Blocks of a stacked launch: one for each ``tile`` pairs of each of
    the bucket's segments (the unpacked entry's tile is 8 pairs, 16 lanes
    a pair)."""
    return seg_pad * -(-B // tile)


def _stacked_launch(name, st, patterns, k):
    """Launch ``name`` once for the whole catalog and batch; the packed
    entry in tiles of ``stacked_plan``'s size."""
    out, args = stacked_launch_args(name, st, patterns, k)
    if patterns.shape[0]:
        plan = ()
        if st.bits:
            occ = stacked_occupancy(st)
            plan = (stacked_plan(patterns.shape[0], st.n_seg,
                                 occ["blocks_per_sm"] * occ["sms"]),)
        _build.launch(name, *args, *plan, *(t.data_ptr() for t in out))
    return out


@traffic.reports("fm_query_stacked_packed",
                 lambda st, patterns, k=0: traffic.stacked_query_bytes(st, patterns, k)[0])
def fm_query_stacked_packed(st, patterns, k: int = 0):
    """(sp, ep, positions) of every pattern in every segment of a packed
    bucket (``st.bits`` 2 or 4); the plain version for CPU tensors, one
    kernel launch otherwise."""
    fused = st.fused
    if st.bits not in (2, 4) or fused is None or st.sigma > 1 << st.bits:
        raise ValueError(f"fm_query_stacked_packed: no packed layout "
                         f"(bits={st.bits}, sigma={st.sigma})")
    if _build.on_cpu(fused, st.c_array, patterns):
        return fm_query_stacked_packed_plain(st, patterns, k)
    return _stacked_launch("fm_query_stacked_packed", st, patterns, k)


@traffic.reports("fm_query_stacked_unpacked",
                 lambda st, patterns, k=0: traffic.stacked_query_bytes(st, patterns, k)[0])
def fm_query_stacked_unpacked(st, patterns, k: int = 0):
    """(sp, ep, positions) of every pattern in every segment of an
    unpacked bucket; the plain version for CPU tensors, one kernel launch
    otherwise."""
    if _build.on_cpu(st.blocks, st.occ, st.c_array, patterns):
        return fm_query_stacked_unpacked_plain(st, patterns, k)
    return _stacked_launch("fm_query_stacked_unpacked", st, patterns, k)
