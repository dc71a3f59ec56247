"""FM-index rank queries: the packed fused-row rank (sigma <= 16) and the
unpacked in-block count (sigma > 16), each as a plain PyTorch version and a
hand-written CUDA kernel (``csrc/rank_packed.cu``, ``csrc/rank_select.cu``).
The unpacked kernel's launch is planned here (``rank_select_plan``: lanes
a query, and a grid of at most one resident wave from the kernel's
occupancy, ``rank_select_occupancy``, asked once per card).

Layout (as in the JAX reference): the BWT is planed into 2-bit
(sigma <= 4) or 4-bit (sigma <= 16) fields packed LSB-first into 32-bit
words, and each checkpoint block is one fused row

    fused[b] = [ Occ checkpoint (sigma int32) | packed words (r/fpw int32) ]

``rank_packed`` / ``rank_select`` dispatch on the tensors' device: CPU
tensors take the plain version, CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, traffic
from ._bits import i32, popcount32, u32

# LSB of every 2-bit / 4-bit field: replicating a symbol across fields is
# one multiply; a field equals the symbol iff its XOR-difference is zero.
_REP = {2: 0x55555555, 4: 0x11111111}


def packed_bits(sigma: int, sample_rate: int) -> int:
    """Field width for (sigma, block length r): 2, 4, or 0 (unpackable)."""
    for bits in (2, 4):
        if sigma <= (1 << bits) and sample_rate % (32 // bits) == 0:
            return bits
    return 0


def pack_words(symbols: torch.Tensor, bits: int) -> torch.Tensor:
    """int32[k*fpw] symbols in [0, 2^bits) -> int32[k] packed words.

    Negative entries (PAD tails) pack as 0; rank queries never reach them
    because in-block cutoffs are bounded by the true text length.  Built one
    field at a time, so the int64 transient is one word per output word.
    """
    fpw = 32 // bits
    v = symbols.clamp(min=0).view(-1, fpw)
    words = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    for j in range(fpw):
        words |= v[:, j].to(torch.int64) << (bits * j)
    return i32(words)


def _eq_fields(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-field zero test on XOR-ed words (int64 in [0, 2^32)): the LSB of
    each field is 1 iff the whole field is 0 (the symbols matched)."""
    rep = _REP[bits]
    t = x | (x >> 1)
    if bits == 4:
        t = t | (t >> 2)
    return (t & rep) ^ rep


def _cutoff_mask(word_iota: torch.Tensor, cutoff: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """int64 select mask keeping only the first ``cutoff`` fields of a block
    laid out over consecutive words (cutoff in [0, r])."""
    fpw = 32 // bits
    full = cutoff // fpw
    rem = (cutoff - full * fpw).to(torch.int64)
    partial = (torch.ones_like(rem) << (bits * rem)) - 1
    return torch.where(
        word_iota < full,
        torch.full_like(partial, 0xFFFFFFFF),
        torch.where(word_iota == full, partial, torch.zeros_like(partial)),
    )


def rank_packed_plain(fused, block_idx, c, cutoff, *, bits: int, sigma: int):
    """Popcount rank over the fused layout, in plain PyTorch.

    fused int32[nb, sigma + W]; block_idx/c/cutoff int32[B] -> int32[B]:
    Occ checkpoint + count of c in the first ``cutoff`` symbols of the
    selected block."""
    rows = fused[block_idx.long()]                           # (B, sigma+W)
    base = rows.gather(1, c.long()[:, None])[:, 0]
    w = u32(rows[:, sigma:])                                 # (B, W)
    eq = _eq_fields(w ^ (u32(c) * _REP[bits])[:, None], bits)
    wi = torch.arange(w.shape[1], device=w.device)[None, :]
    sel = _cutoff_mask(wi, cutoff[:, None], bits)
    cnt = popcount32(eq & sel).sum(dim=1)
    return (base.to(torch.int64) + cnt).to(torch.int32)


@traffic.reports("rank_packed", lambda fused, block_idx, c, cutoff, *, bits,
                 sigma: traffic.rank_packed_bytes(fused, block_idx, c, cutoff,
                                                  sigma, bits))
def rank_packed(fused, block_idx, c, cutoff, *, bits: int, sigma: int):
    """Occ(c_i, block_idx_i * r + cutoff_i) over the fused packed layout;
    the plain version for CPU tensors, the CUDA kernel otherwise (``meta``
    tensors: an empty result, nothing launched)."""
    if _build.on_cpu(fused, block_idx, c, cutoff):
        return rank_packed_plain(fused, block_idx, c, cutoff,
                                 bits=bits, sigma=sigma)
    meta = _build.traced("rank_packed", fused, block_idx, c, cutoff)
    if bits not in _REP or fused.dim() != 2 or fused.shape[1] <= sigma:
        raise ValueError(f"rank_packed: bad layout {tuple(fused.shape)}, "
                         f"bits={bits}, sigma={sigma}")
    B = block_idx.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=fused.device)
    if B and not meta:
        _build.launch("rank_packed", fused.data_ptr(), fused.shape[1], sigma,
                      bits, block_idx.data_ptr(), c.data_ptr(),
                      cutoff.data_ptr(), out.data_ptr(), B)
    return out


def rank_select_plain(bwt_blocks, block_idx, c, cutoff):
    """Count of ``c[q]`` among the first ``cutoff[q]`` symbols of block
    ``block_idx[q]``, in plain PyTorch: int32[nb, r] + int32[B] x 3 ->
    int32[B]."""
    r = bwt_blocks.shape[1]
    blocks = bwt_blocks[block_idx.long()]                    # (B, r)
    pos = torch.arange(r, device=blocks.device)[None, :]
    hit = (blocks == c[:, None]) & (pos < cutoff[:, None])
    return hit.sum(dim=1).to(torch.int32)


THREADS = 256              # threads a block of rank_select.cu
GROUPS = (4, 8, 16, 32)    # lanes a query the kernel is built for
# the C occupancy query's argument types: group, vec, out
OCCUPANCY_ARGTYPES = ("c_int", "c_int", "c_void_p")
_occupancy: dict = {}


def rank_group(r: int, group: int | None = None) -> int:
    """Lanes a query of ``rank_select.cu`` over blocks of ``r`` symbols:
    ``group`` if given (one the kernel is built for), else the fewest
    whose two 16-byte chunks a lane (8 symbols) cover the block in one
    step, from 4 up to the warp's 32."""
    if group is not None:
        if group not in GROUPS:
            raise ValueError(f"rank_select: no kernel for group {group}; "
                             f"built for {GROUPS}")
        return group
    G = GROUPS[0]
    while G < GROUPS[-1] and 8 * G < r:
        G *= 2
    return G


def rank_select_plan(B: int, r: int, resident: int,
                     group: int | None = None) -> dict:
    """The launch of ``B`` queries over blocks of ``r`` symbols on a card
    that holds ``resident`` blocks of ``THREADS`` at once: G lanes a query
    (``group``, else ``rank_group(r)`` halved while the batch's B x G
    lanes exceed one resident wave, down to 4: past a wave a group answers
    query after query, and fewer lanes a query spend fewer instructions on
    each), 32 / G queries a warp, and a block for each THREADS / G queries
    up to one resident wave; the groups stride over the queries beyond
    it."""
    G = rank_group(r, group)
    if group is None:
        while G > GROUPS[0] and B * G > resident * THREADS:
            G //= 2
    need = -(-B * G // THREADS)
    return {"group": G, "queries_per_warp": 32 // G,
            "grid": max(1, min(need, resident))}


def rank_select_occupancy(device, group: int, vector: bool) -> dict:
    """Registers, spilled bytes and resident blocks per SM of the kernel of
    ``group`` lanes a query and its loads (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), with the card's SMs
    and the blocks it holds at once (``resident``); asked once per kernel
    and card."""
    dev = torch.device(device)
    key = (dev.index, group, vector)
    if key not in _occupancy:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = _build.query(
                "rank_select", "rank_select_occupancy",
                [getattr(ctypes, t) for t in OCCUPANCY_ARGTYPES], group,
                int(vector), out)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if err:
            raise RuntimeError(f"rank_select_occupancy failed: CUDA error "
                               f"{err}")
        occ = dict(zip(("blocks_per_sm", "registers", "threads",
                        "local_bytes"), list(out)), sms=sms)
        occ["resident"] = occ["blocks_per_sm"] * sms
        _occupancy[key] = occ
    return _occupancy[key]


def vector_loads(bwt_blocks) -> bool:
    """Whether ``rank_select.cu`` reads ``bwt_blocks`` in 16-byte chunks:
    its base 16-byte aligned and its rows whole chunks (r % 4 == 0); a
    view that starts elsewhere takes the same chunks symbol by symbol."""
    return bwt_blocks.data_ptr() % 16 == 0 and bwt_blocks.shape[1] % 4 == 0


def launch_plan(bwt_blocks, B: int, group: int | None = None) -> dict:
    """``rank_select_plan`` of ``B`` queries over ``bwt_blocks`` on their
    card (``group`` forces the lanes a query) with the kernel's loads
    (``vector``).  Every instantiation holds 2048 / THREADS blocks an SM
    (its launch bounds), so the wave is read from the block-covering
    group's occupancy."""
    r = bwt_blocks.shape[1]
    vector = vector_loads(bwt_blocks)
    occ = rank_select_occupancy(bwt_blocks.device, rank_group(r), vector)
    plan = rank_select_plan(B, r, occ["resident"], group)
    plan["vector"] = vector
    return plan


def rank_select_launch(bwt_blocks, block_idx, c, cutoff,
                       plan) -> torch.Tensor:
    """The in-block counts of ``rank_select`` from one launch of
    ``rank_select.cu`` by ``plan`` (``launch_plan``), on CUDA tensors that
    ``rank_select`` has checked."""
    B = block_idx.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=bwt_blocks.device)
    if B:
        _build.launch("rank_select", bwt_blocks.data_ptr(),
                      bwt_blocks.shape[1], block_idx.data_ptr(), c.data_ptr(),
                      cutoff.data_ptr(), out.data_ptr(), B, plan["group"],
                      int(plan["vector"]), plan["grid"])
    return out


@traffic.reports("rank_select", lambda bwt_blocks, block_idx, c, cutoff:
                 traffic.rank_select_bytes(bwt_blocks, block_idx, cutoff))
def rank_select(bwt_blocks, block_idx, c, cutoff):
    """In-block counts over unpacked int32 blocks (checkpoint NOT
    included); the plain version for CPU tensors, the CUDA kernel
    otherwise (``launch_plan``).  ``meta`` tensors get an empty result
    and ask the card nothing (no plan, no launch)."""
    if _build.on_cpu(bwt_blocks, block_idx, c, cutoff):
        return rank_select_plain(bwt_blocks, block_idx, c, cutoff)
    meta = _build.traced("rank_select", bwt_blocks, block_idx, c, cutoff)
    if bwt_blocks.dim() != 2:
        raise ValueError(f"rank_select: blocks must be int32[n_blocks, r], "
                         f"got {tuple(bwt_blocks.shape)}")
    B = block_idx.shape[0]
    if meta:
        return torch.empty(B, dtype=torch.int32, device="meta")
    return rank_select_launch(bwt_blocks, block_idx, c, cutoff,
                              launch_plan(bwt_blocks, B) if B else None)
