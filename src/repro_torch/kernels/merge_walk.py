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
  lengths.  The walked segments' (symbol, LF) pairs enter as ``clf`` in
  the same layout.

On the card a walk is cut into chains (the kernel's header says how):
``Seeds`` gives the walked rows at the SA sample's positions,
``walk_plan`` the seed stride from the kernel's resident warps
(``walk_occupancy``, asked once per card), ``seed_count`` and
``seed_table`` the seeds, which the kernel finds by itself.
``chained_walk`` is the chained design in plain PyTorch (the plan's seeds,
the two bounding walks, the hand-over), for the tests and ``chip_smoke``
only: the main path never calls it.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise; operands on different devices raise ``ValueError``.  Launches are
counted in ``_build.LAUNCHES["merge_walk"]``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build, traffic
from .fm_query import packed_symbol
from .rank_select import rank_packed_plain, rank_select_plain

THREADS = 128          # threads a block of the chained kernels
WARP = 32
MAX_CHAIN_LANES = 32   # k-way runs past it: one block walks one chain


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


# -- chains -------------------------------------------------------------------

class Seeds(NamedTuple):
    """The walked segments' own rows at text positions 0, rate, 2 rate, ...
    (each one's SA sample by position), segment after segment in ``ins``
    order, and the rate."""
    rows: torch.Tensor
    rate: int


def chain_lanes(k: int) -> int | None:
    """Threads of one chain of a k-way walk: its k_pad lanes (the next
    power of two, at least 2) up to 32; None past that, where the warps of
    one block walk the one chain."""
    if k > MAX_CHAIN_LANES:
        return None
    lanes = 2
    while lanes < k:
        lanes *= 2
    return lanes


def walk_plan(steps: int, lanes: int, rate: int, resident_warps: int) -> dict:
    """The seed stride of a chained launch of ``steps`` transitions with
    ``lanes`` threads a chain (1 pairwise, k_pad k-way) on a card holding
    ``resident_warps`` warps of the kernel at once: the least multiple of
    the SA sample ``rate`` that leaves no more seeds (one every ``stride``
    steps) than the card holds chains (``slots``), so every chain is
    resident in one wave; 0 (one chain) with no SA sample or no step to
    cut.  A seed's window is its stride, so a chain runs one seed's
    bounding walks at a time."""
    slots = resident_warps * (WARP // lanes)
    stride = 0
    if rate > 0 and steps >= 2 and slots >= 1:
        stride = rate * max(1, -(-steps // (rate * slots)))
    return {"stride": stride, "slots": slots,
            "chains_per_block": THREADS // lanes}


def walk_grid(n_seeds: int, lanes: int) -> int:
    """Blocks of a chained launch: the anchor's chain and one per seed,
    ``THREADS // lanes`` chains a block."""
    return -(-(n_seeds + 1) // (THREADS // lanes))


def seed_count(lens, stride: int) -> int:
    """Seeds of a walk over walked segments of ``lens`` (segment 1 first;
    the last one is walked first) at ``stride``: one at every position p
    = q * stride > 0, but the anchor's (the first walked segment's last
    row); 0 without a stride."""
    if stride <= 0:
        return 0
    n = sum((m - 1) // stride for m in lens)
    return n - ((lens[-1] - 1) % stride == 0 and lens[-1] > 1)


def seed_table(seeds: Seeds, lens, stride: int) -> torch.Tensor:
    """int32[n, 4] (step, own row, window end, segment) of a walk's seeds
    in step order, on the seeds' device.  ``lens``: the walked segments'
    lengths, segment 1 first (pairwise: [nB]); segment s is walked over
    steps [first_s, last_s], segment k-1 first from step 0, position p at
    step first_s + len_s - 1 - p.  A seed sits at every position p > 0
    that is a multiple of ``stride`` (itself a multiple of the rate),
    except the anchor's step 0; its window ends ``stride`` steps later,
    inside its segment.  The kernel finds the same seeds itself, from the
    segments' lengths and the stride (``seed_count`` of them)."""
    rate = seeds.rate
    if stride <= 0 or stride % rate:
        raise ValueError(f"seed stride {stride} is not a positive multiple "
                         f"of the SA sample rate {rate}")
    per = [-(-n // rate) for n in lens]
    base = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    cols, end = [], -1
    for s in range(len(lens), 0, -1):
        n, first = lens[s - 1], end + 1
        end += n
        p = np.arange((n - 1) // stride * stride, 0, -stride, dtype=np.int64)
        t = first + n - 1 - p
        p, t = p[t > 0], t[t > 0]
        cols.append(np.stack([t, base[s - 1] + p // rate, t + stride,
                              np.full_like(t, s)]))
    tab = (np.concatenate(cols, axis=1) if cols
           else np.zeros((4, 0), np.int64))
    dev = seeds.rows.device
    idx = torch.from_numpy(tab[1]).to(dev)
    out = torch.from_numpy(tab.T.astype(np.int32)).to(dev)
    out[:, 1] = seeds.rows[idx].to(torch.int32)
    return out.contiguous()


def chain_stats(table, meets, last_step: int) -> dict:
    """What a chained walk did, from its seed table and meeting steps:
    chains (the anchor's and one per met seed), seeds met / tried, the
    median and maximum steps a met seed took to meet, and the longest
    chain in steps, its seed's bounding walk included (each thread's
    transitions: from its seed's step, or 0, to where the next chain takes
    over or the walk ends; a failed seed's thread to its window's end)."""
    tab = table.cpu().numpy().astype(np.int64)
    m = meets.cpu().numpy().astype(np.int64)
    met = m >= 0
    to_meet = m[met] - tab[met, 0]
    begin = np.concatenate([[0], tab[met, 0]])      # a thread's first step
    take = np.concatenate([m[met], [last_step]])    # where the next takes over
    spans = np.concatenate([take - begin, tab[~met, 2] - tab[~met, 0]])
    return {"chains": int(met.sum()) + 1, "seeds_met": int(met.sum()),
            "seeds_tried": int(len(m)),
            "median_steps_to_meet": float(np.median(to_meet))
            if to_meet.size else None,
            "max_steps_to_meet": int(to_meet.max()) if to_meet.size else None,
            "longest_chain": int(spans.max())}


# the C occupancy query's argument types: kway, bits, sigma, k, out
OCCUPANCY_ARGTYPES = ("c_int", "c_int", "c_int", "c_int", "c_void_p")
_occupancy: dict = {}


def walk_occupancy(kway: bool, bits: int, sigma: int, k: int,
                   device) -> dict:
    """Registers, spilled bytes and resident blocks per SM of the chained
    kernel a walk launches (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: its shared memory
    depends on sigma and, k-way, on k), with the card's SMs and resident
    warps; asked once per kernel, layout and card."""
    dev = torch.device(device)
    key = (dev.index, kway, bits, sigma, k if kway else 0)
    if key not in _occupancy:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = _build.query(
                "merge_walk", "merge_walk_occupancy",
                [getattr(ctypes, t) for t in OCCUPANCY_ARGTYPES],
                int(kway), bits, sigma, k, out)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if err:
            raise RuntimeError(f"merge_walk_occupancy failed: CUDA error "
                               f"{err}")
        occ = dict(zip(("blocks_per_sm", "registers", "threads",
                        "local_bytes"), list(out)), sms=sms)
        occ["resident_warps"] = occ["blocks_per_sm"] * sms * THREADS // WARP
        _occupancy[key] = occ
    return _occupancy[key]


def _chains(kway: bool, steps: int, lanes, seeds, lens, *, bits: int,
            sigma: int, k: int, device, stride, report) -> tuple:
    """The C arguments (seed rows, rate, stride, seeds, meets) of a chained
    launch: the plan's stride (or ``stride``), no seeds without ``seeds``
    or past 32 lanes.  With a ``report`` dict the launch writes the seeds'
    meeting steps, and the report receives them with the plan and the seed
    table."""
    plan = {"stride": 0}
    if seeds is not None and lanes is not None:
        occ = walk_occupancy(kway, bits, sigma, k, device)
        plan = {**walk_plan(steps, lanes, seeds.rate, occ["resident_warps"]),
                **occ}
        if stride is not None:
            plan["stride"] = stride
    n = seed_count(lens, plan["stride"])
    plan.update(n_seeds=n, grid=walk_grid(n, lanes) if lanes else 1)
    if n and plan["stride"] % seeds.rate:
        raise ValueError(f"seed stride {plan['stride']} is not a multiple "
                         f"of the SA sample rate {seeds.rate}")
    meets = None
    if report is not None:
        meets = torch.full((n,), -1, dtype=torch.int32, device=device)
        table = (seed_table(seeds, lens, plan["stride"]) if n else
                 torch.zeros((0, 4), dtype=torch.int32, device=device))
        report.update(plan=plan, seeds=table, meets=meets)
    return (seeds.rows.data_ptr() if n else None,
            seeds.rate if n else 1, plan["stride"] if n else 0, n,
            meets.data_ptr() if n and meets is not None else None)


# -- the chained design in plain PyTorch (tests and chip_smoke only) ----------

class WalkForm(NamedTuple):
    """A walk in k-way form for ``chained_walk``: lanes 0 .. L-1, of which
    the first k are segments (pairwise: the left operand and the walked
    right one).  ``rank(lane, c, I)`` gives each lane's Occ(c, I) over its
    own rows; ``C`` int32[L, sigma], ``rows`` / ``lasts`` int32[L] each
    segment's BWT row of suffix 0 and last character, ``hi`` int32[L] its
    length (the upper bound's start; 0 on pad lanes), ``ranked`` bool[L]
    the lanes a step moves by the rank formula (the others only by the
    walked lane's own row); ``clf`` the walked segments' (symbol, LF)
    rows, segment 1 first, ``lens`` their lengths."""
    rank: object
    C: torch.Tensor
    rows: torch.Tensor
    lasts: torch.Tensor
    hi: torch.Tensor
    ranked: torch.Tensor
    k: int
    clf: torch.Tensor
    lens: list


def pairwise_form(a_fused, a_blocks, a_occ, a_c, b_c, clf, ends, *,
                  sigma: int, bits: int, r: int) -> WalkForm:
    """``merge_walk``'s arguments as a k = 2 walk: lane 0 the left operand,
    lane 1 the walked right one (held at its own row)."""
    nbA = (a_fused if bits else a_blocks).shape[0]

    def rank(lane, c, I):
        blk = torch.clamp(I // r, max=nbA - 1)
        return _rank_plain(a_fused, a_blocks, a_occ, blk, c, I - blk * r,
                           bits=bits, sigma=sigma)

    ends = ends.to(torch.int32)
    dev = clf.device
    return WalkForm(
        rank, torch.stack([a_c, b_c]).to(torch.int32), ends[[0, 2]],
        ends[[1, 3]],
        torch.tensor([nbA * r, clf.shape[0]], dtype=torch.int32, device=dev),
        torch.tensor([True, False], device=dev), 2, clf, [clf.shape[0]])


def kway_form(fused, blocks, occ, c_mat, nb_vec, row_vec, last_vec, lens,
              clf, *, sigma: int, bits: int, r: int) -> WalkForm:
    """``kway_walk``'s arguments as a ``WalkForm``: lane s segment s over
    its stacked rows."""
    k, k_pad = len(lens), c_mat.shape[0]
    nb_pad = (fused if bits else blocks).shape[0] // k_pad

    def rank(lane, c, I):
        blk = torch.minimum(I // r, nb_vec[lane.long()] - 1)
        return _rank_plain(fused, blocks, occ, lane * nb_pad + blk, c,
                           I - blk * r, bits=bits, sigma=sigma)

    dev = c_mat.device
    lanes = torch.arange(k_pad, device=dev)
    hi = torch.zeros(k_pad, dtype=torch.int32, device=dev)
    hi[:k] = torch.tensor(lens, dtype=torch.int32, device=dev)
    return WalkForm(rank, c_mat.to(torch.int32), row_vec[:k_pad],
                    last_vec[:k_pad], hi, lanes < k, k, clf, list(lens[1:]))


def chained_walk(form: WalkForm, table, *, trace: bool = False) -> dict:
    """The chained walk of the kernel, in plain PyTorch over a
    ``WalkForm`` and a ``seed_table``: every seed's two bounding walks from
    its (step, own row), all lanes but the walked one at 0 and at their
    lengths, the walked one held at its own row, over its window (meeting
    at the first step where they are equal in every lane); then the chains
    (the anchor's, one per met seed from its meeting state) walked exactly
    up to where the next one takes over.  Returns {"ins", "meets",
    "starts", "ends"} and, with ``trace``, "states" int32[steps + 1, L]
    (the exact walk, one row per step) and "lo" / "hi" int32[n, W + 1, L]
    (each seed's bounds from its step, walked to the end of its window)."""
    rank, C, rows, lasts, hi, ranked, k, clf, lens = form
    dev = C.device
    L = C.shape[0]
    lanes = torch.arange(L, device=dev)
    real = lanes < k
    off, end = [0, 0], [0] * k
    for n in lens[:-1]:
        off.append(off[-1] + n)
    e = -1
    for s in range(k - 1, 0, -1):
        e += lens[s - 1]
        end[s] = e
    off_t = torch.tensor(off[:k], device=dev)
    end_t = torch.tensor(end, device=dev)
    n_rows = sum(lens)
    ins = torch.zeros(n_rows, dtype=torch.int32, device=dev)

    def advance(t, seg, rr):
        """(symbol, own row after the step, segment after it)."""
        boundary = t == end_t[seg]
        pair = clf[(off_t[seg] + rr).long()]
        prev = (seg - 1).clamp(min=0)
        c = torch.where(boundary, lasts[prev], pair[:, 0])
        rr_n = torch.where(boundary, C[prev, lasts[prev].long()], pair[:, 1])
        return c, rr_n, seg - boundary.long()

    def step(X, c, seg, rr_n):
        """One step of states X [B, L] on symbols c [B], the walked lane
        (segment ``seg`` after the step) set to its own row ``rr_n``."""
        B = X.shape[0]
        cmp = (rows < X).int()
        nxt = torch.roll(cmp, -1, 1)
        nxt[:, k - 1] = 1
        corr = torch.where(lasts == c[:, None], nxt - cmp, 0)
        cc = c[:, None].expand(B, L)
        occ = rank(lanes.expand(B, L).reshape(-1).to(torch.int32),
                   cc.reshape(-1).to(torch.int32).contiguous(),
                   X.reshape(-1).to(torch.int32)).view(B, L)
        Xn = torch.where(ranked, C[lanes, cc.long()] + occ + corr, X)
        Xn = torch.where(real, Xn, 0).to(torch.int32)
        Xn[torch.arange(B, device=dev), seg] = rr_n.to(torch.int32)
        return Xn

    # the seeds: both bounds over each window, all seeds at once
    n = table.shape[0]
    tab = table.long()
    t, rr, seg, wend = tab[:, 0].clone(), tab[:, 1].clone(), tab[:, 3], \
        tab[:, 2]
    ar = torch.arange(n, device=dev)
    lo = torch.zeros((n, L), dtype=torch.int32, device=dev)
    up = hi.expand(n, L).clone()
    lo[ar, seg] = up[ar, seg] = rr.to(torch.int32)
    meets = torch.full((n,), -1, dtype=torch.long, device=dev)
    met_X = torch.zeros_like(lo)
    met_rr = torch.zeros_like(rr)
    W = int((wend - t).max()) if n else 0
    out = {}
    if trace:
        out["lo"] = torch.zeros((n, W + 1, L), dtype=torch.int32, device=dev)
        out["hi"] = torch.zeros_like(out["lo"])
        out["lo"][:, 0], out["hi"][:, 0] = lo, up
    for i in range(W):
        live = (t < wend) & ((meets < 0) | trace)
        if not bool(live.any()):
            break
        c, rr_n, _ = advance(t, seg, rr)
        lo = torch.where(live[:, None], step(lo, c, seg, rr_n), lo)
        up = torch.where(live[:, None], step(up, c, seg, rr_n), up)
        rr = torch.where(live, rr_n, rr)
        t = t + live.long()
        new = live & (meets < 0) & (lo == up).all(1)
        meets[new], met_X[new], met_rr[new] = t[new], lo[new], rr[new]
        if trace:
            out["lo"][:, i + 1], out["hi"][:, i + 1] = lo, up
    # the chains: the anchor's and each met seed's, exact
    met = meets >= 0
    a_rr = C[k - 1, lasts[k - 1].long()].long()
    X0 = torch.where(real, C[lanes, lasts[k - 1].long()], 0).to(torch.int32)
    X0[k - 1] = a_rr
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        meets[met]])
    ends = torch.cat([starts[1:], torch.tensor([n_rows], device=dev)])
    X = torch.cat([X0[None], met_X[met]])
    t = starts.clone()
    seg = torch.cat([torch.tensor([k - 1], device=dev), seg[met]])
    rr = torch.cat([a_rr[None], met_rr[met]])
    ar = torch.arange(X.shape[0], device=dev)
    states = (torch.zeros((n_rows, L), dtype=torch.int32, device=dev)
              if trace else None)

    def record(mask):
        idx = (off_t[seg] + rr)[mask].long()
        ins[idx] = (X.sum(1) - X[ar, seg])[mask].to(torch.int32)
        if trace:
            states[t[mask]] = X[mask]

    record(ends > starts)
    while True:
        live = t < ends - 1
        if not bool(live.any()):
            break
        c, rr_n, seg_n = advance(t, seg, rr)
        X = torch.where(live[:, None], step(X, c, seg_n, rr_n), X)
        rr = torch.where(live, rr_n, rr)
        seg = torch.where(live, seg_n, seg)
        t = t + live.long()
        record(live)
    out.update(ins=ins, meets=meets.to(torch.int32), starts=starts,
               ends=ends)
    if trace:
        out["states"] = states
    return out


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


def _seed_rows(name: str, seeds, lens) -> tuple:
    """The seeds' rows as a launch takes them (raises unless there is one
    per multiple of the rate below each walked length)."""
    if seeds is None:
        return ()
    want = sum(-(-n // seeds.rate) for n in lens)
    if seeds.rate < 1 or seeds.rows.dim() != 1 or seeds.rows.numel() != want:
        raise ValueError(f"{name}: seeds must hold {want} rows (one per "
                         f"multiple of the rate below each walked length)")
    _build.check_cuda(name, seeds.rows)
    return (seeds.rows,)


@traffic.reports("merge_walk", lambda a_fused, a_blocks, a_occ, a_c, b_c,
                 clf, ends, seeds=None, **_: traffic.walk_bytes(
                     clf.shape[0], a_c, b_c, clf, ends) + 4 * clf.shape[0])
def merge_walk(a_fused, a_blocks, a_occ, a_c, b_c, clf, ends, seeds=None, *,
               sigma: int, bits: int, r: int, stride: int | None = None,
               report: dict | None = None):
    """Pairwise interleave counts ins int32[nB] (``merge_walk_plain``'s
    contract); one kernel launch for CUDA tensors: the anchor's chain and
    one from each of the right operand's ``seeds`` (``Seeds``; None: one
    chain) that meets, a seed every ``stride`` steps (None: ``walk_plan``'s
    stride).  A ``report`` dict receives the plan, the seed table and the
    seeds' meeting steps."""
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
    _seed_rows("merge_walk", seeds, [nB])
    ins = torch.empty(nB, dtype=torch.int32, device=clf.device)
    if nB:
        chains = _chains(False, nB - 1, 1, seeds, [nB], bits=bits,
                         sigma=sigma, k=2, device=clf.device, stride=stride,
                         report=report)
        _build.launch("merge_walk",
                      *_layout_args(a_fused, a_blocks, a_occ, sigma), nbA,
                      sigma, bits, r, a_c.data_ptr(), b_c.data_ptr(),
                      clf.data_ptr(), nB, ends.data_ptr(), *chains,
                      ins.data_ptr())
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
                 row_vec, last_vec, lens, clf=None, seeds=None, **_:
                 traffic.walk_bytes(sum(lens[1:]), c_mat, nb_vec, row_vec,
                                    last_vec, *(() if clf is None else (clf,)))
                 + 4 * sum(lens[1:]))
def kway_walk(fused, blocks, occ, c_mat, nb_vec, row_vec, last_vec, lens,
              clf=None, seeds=None, *, sigma: int, bits: int, r: int,
              stride: int | None = None, report: dict | None = None):
    """K-way interleave counts (``kway_walk_plain``'s contract); one kernel
    launch for CUDA tensors, which needs the walked segments' (symbol, LF)
    rows ``clf`` int32[sum(lens[1:]), 2]: for k <= 32 the anchor's chain and
    one from each of ``seeds`` (``Seeds``; None: one chain) that meets, a
    seed every ``stride`` steps (None: ``walk_plan``'s stride); past 32
    segments one chain.  ``report`` as for ``merge_walk``."""
    rows, n_rows = _layout("kway_walk", fused, blocks, occ, sigma=sigma,
                           bits=bits, r=r)
    extra = () if clf is None else (clf,)
    if _on_cpu("kway_walk", *rows, c_mat, nb_vec, row_vec, last_vec, *extra):
        return kway_walk_plain(fused, blocks, occ, c_mat, nb_vec, row_vec,
                               last_vec, lens, sigma=sigma, bits=bits, r=r)
    k = len(lens)
    k_pad = c_mat.shape[0]
    if (k < 2 or c_mat.dim() != 2 or k_pad < k or c_mat.shape[1] != sigma
            or n_rows % k_pad
            or min(v.numel() for v in (nb_vec, row_vec, last_vec)) < k):
        raise ValueError(f"kway_walk: bad run (k={k}, c_mat "
                         f"{tuple(c_mat.shape)}, {n_rows} stacked rows)")
    walked = sum(lens[1:])
    if clf is None or tuple(clf.shape) != (walked, 2):
        raise ValueError(f"kway_walk: clf must be int32[{walked}, 2]")
    lanes = chain_lanes(k)
    if lanes is None:
        seeds = None
    _seed_rows("kway_walk", seeds, lens[1:])
    nb_pad = n_rows // k_pad
    dev = c_mat.device
    len_vec = torch.tensor(lens, dtype=torch.int32, device=dev)
    ins = torch.empty(walked, dtype=torch.int32, device=dev)
    chains = _chains(True, walked - 1, lanes, seeds, lens[1:], bits=bits,
                     sigma=sigma, k=k, device=dev, stride=stride,
                     report=report)
    _build.launch("merge_walk", *_layout_args(fused, blocks, occ, sigma),
                  nb_pad, sigma, bits, r, c_mat.data_ptr(), nb_vec.data_ptr(),
                  row_vec.data_ptr(), last_vec.data_ptr(), len_vec.data_ptr(),
                  k, clf.data_ptr(), *chains, ins.data_ptr(),
                  entry="merge_walk_kway")
    return ins
