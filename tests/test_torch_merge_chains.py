"""The chained design of the merge walk kernel (``csrc/merge_walk.cu``) in
its plain model, ``kernels/merge_walk.chained_walk``, on the CPU: the plan,
the seeds, the two bounding walks and the hand-over between chains.

The model's ``ins`` must equal the plain walks' (``merge_walk_plain`` /
``kway_walk_plain``) and the JAX package's ``_merge_walk`` /
``_kway_walk`` on ``test_torch_bwt_merge.py``'s matrix (its JAX side
shared with that file, once per test session), at several seed strides; every output is an integer, so the tolerance is exact equality.
A hypothesis property holds the bounds around the exact walk.  Walks where
no seed meets (a repeated document, a run of tiny documents) are one
chain.  The plan, grid and seed table are checked by hand, and the
wrappers' C arguments against the source.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
# test_torch_bwt_merge.py's matrix and its JAX side: the operands built by
# the JAX package and carried across, the JAX walks' ins
from test_torch_bwt_merge import (
    CASES,
    _corpus_docs,
    _jax_kway_ins,
    _jax_merge,
    _jax_pair_ins,
)
from test_torch_bwt_merge import _operands as _jax_built
from torch_session_cache import session_cache_root  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

from repro_torch.core import bwt_merge as bm
from repro_torch.core.pipeline import build_index_prepared, prepare_tokens
from repro_torch.data.corpus import corpus
from repro_torch.kernels import _build
from repro_torch.kernels import merge_walk as mw


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_operands(docs, sigma_decl, r, srate, pack=None):
    """(JAX indexes, the same carried into the port)."""
    return _jax_built(docs, sigma_decl, r, srate, pack)[2:]


def _operands(docs, sigma_decl, r, srate, pack=None):
    """The port's own builds (no JAX), for the tests that need no
    reference beyond the plain walks."""
    out = []
    for d in docs:
        s, sig = prepare_tokens(np.asarray(d, np.int32), r, sigma_decl)
        out.append(build_index_prepared(s, sig, sample_rate=r,
                                        sa_sample_rate=srate, pack=pack,
                                        device="cpu").fm)
    return out


def _kw(fm):
    return dict(sigma=fm.sigma, bits=fm.bits, r=fm.sample_rate)


def _pair_walk(left, right):
    """(form, plain ins, seeds, walked lengths) of the pairwise walk
    ``merge_fm_indexes`` launches."""
    clf, ends = bm._pairwise_walk_inputs(left, right)
    args = (*bm._rank_rows(left), left.c_array, right.c_array, clf, ends)
    return (mw.pairwise_form(*args, **_kw(left)),
            mw.merge_walk_plain(*args, **_kw(left)),
            bm._walk_seeds([right]), [right.length])


def _kway_walk(fms):
    """(form, plain ins, seeds, walked lengths) of ``merge_kway``'s walk."""
    args = bm._kway_walk_inputs(fms)
    return (mw.kway_form(*args[:9], **_kw(fms[0])),
            mw.kway_walk_plain(*args[:8], **_kw(fms[0])),
            bm._walk_seeds(fms[1:]), [f.length for f in fms[1:]])


def _strides(rate, steps):
    """The SA rate, its double and a stride near a quarter of the walk."""
    quarter = rate * max(1, steps // (4 * rate))
    return sorted({rate, 2 * rate, quarter})


def _chained(walk, stride):
    form, _, seeds, lens = walk
    return mw.chained_walk(form, mw.seed_table(seeds, lens, stride))


def _hold(walk, want=None):
    """The model's ins equal to the plain walk's (and ``want``) at every
    stride of ``_strides``; returns the seeds met over all strides."""
    form, plain, seeds, lens = walk
    if want is not None:
        assert np.array_equal(plain.numpy(), want)
    met = 0
    for stride in _strides(seeds.rate, sum(lens) - 1):
        out = _chained(walk, stride)
        assert torch.equal(out["ins"], plain), stride
        met += int((out["meets"] >= 0).sum())
    return met


@pytest.mark.parametrize("name", list(CASES))
def test_kway_chains_match_reference(name):
    make, sigma_decl, r, srate, pack = CASES[name]
    jfms, tfms = _jax_operands(make(), sigma_decl, r, srate, pack)
    _hold(_kway_walk(tfms), _jax_kway_ins(jfms))


@pytest.mark.parametrize("name", list(CASES))
def test_fold_chains_match_reference(name):
    """Every pairwise walk of the fold (the right operand multi-document
    from the second one), each against the JAX ``_merge_walk``."""
    make, sigma_decl, r, srate, pack = CASES[name]
    jfms, tfms = _jax_operands(make(), sigma_decl, r, srate, pack)
    acc, jacc = tfms[-1], jfms[-1]
    for left, jleft in zip(reversed(tfms[:-1]), reversed(jfms[:-1])):
        _hold(_pair_walk(left, acc), _jax_pair_ins(jleft, jacc))
        acc = bm.merge_fm_indexes(left, acc, pack=pack)
        jacc = _jax_merge(jleft, jacc, pack)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 7, 8, 9, 33])
def test_kway_chains_any_run_length(k):
    """Non-power-of-two runs, k > 8 and k = 33 (the model has no lane
    limit; the kernel walks k > 32 as one chain)."""
    rng = np.random.default_rng(100 + k)
    sizes = rng.choice([5, 13, 29, 61], k, p=[0.4, 0.3, 0.2, 0.1])
    docs = [rng.integers(1, 4, int(n)).astype(np.int32) for n in sizes]
    jfms, tfms = _jax_operands(docs, 4, 8, 4)
    _hold(_kway_walk(tfms), _jax_kway_ins(jfms))


def test_dna_seeds_meet_and_chains_hand_over():
    """On DNA documents most seeds meet within a few steps, the walk
    splits into many chains, and each chain ends where the next begins."""
    fms = _operands(_corpus_docs("dna", (3000, 2000, 1200)), 6, 64, 32)
    walk = _kway_walk(fms)
    out = _chained(walk, 32)
    assert torch.equal(out["ins"], walk[1])
    tab = mw.seed_table(walk[2], walk[3], 32)
    stats = mw.chain_stats(tab, out["meets"], sum(walk[3]) - 1)
    assert stats["seeds_met"] >= 0.9 * stats["seeds_tried"] > 0
    assert stats["chains"] == stats["seeds_met"] + 1
    assert stats["max_steps_to_meet"] <= 32
    assert torch.equal(out["starts"][1:], out["ends"][:-1])
    assert bool((out["starts"][1:] > out["starts"][:-1]).all())


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(sigma=st.integers(2, 6), k=st.integers(2, 5),
       lens=st.lists(st.integers(1, 40), min_size=5, max_size=5),
       seed=st.integers(0, 2**16), mult=st.integers(1, 3),
       kway=st.booleans())
def test_bounds_hold_the_exact_walk(sigma, k, lens, seed, mult, kway):
    """At every step of every seed's window and every lane: lower <= exact
    <= upper, and lower == exact == upper from the meeting step on; the
    meeting step is the first where they are equal; the chains' ins equal
    the plain walk's.  The exact walk is the model with no seeds (one
    chain from the anchor)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, sigma, n).astype(np.int32) for n in lens[:k]]
    fms = _operands(docs, sigma, 8, 4)
    walk = _kway_walk(fms) if kway else _pair_walk(fms[0], fms[1])
    form, plain, seeds, wlens = walk
    none = torch.zeros((0, 4), dtype=torch.int32)
    exact = mw.chained_walk(form, none, trace=True)
    assert torch.equal(exact["ins"], plain)
    tab = mw.seed_table(seeds, wlens, 4 * mult)
    out = mw.chained_walk(form, tab, trace=True)
    assert torch.equal(out["ins"], plain)
    assert torch.equal(out["states"], exact["states"])
    for i, (t0, _, wend, _) in enumerate(tab.tolist()):
        lo, hi = out["lo"][i], out["hi"][i]
        x = exact["states"][t0: wend + 1]
        assert bool((lo[: len(x)] <= x).all() and (x <= hi[: len(x)]).all())
        equal = (lo[: len(x)] == hi[: len(x)]).all(1)
        m = int(out["meets"][i])
        if m >= 0:
            assert not bool(equal[: m - t0].any()) and bool(equal[m - t0])
            assert bool((lo[m - t0: len(x)] == x[m - t0:]).all())
            assert bool((hi[m - t0: len(x)] == x[m - t0:]).all())
        else:
            assert not bool(equal[1:].any())


def test_repeated_document_is_one_chain():
    """A document repeated: every walked context occurs in the other
    copies, no seed meets, and the anchor's chain walks everything."""
    doc = corpus("dna", 500, seed=3)
    for walk in (_kway_walk(_operands([doc] * 3, 6, 16, 4)),
                 _pair_walk(*_operands([doc] * 2, 6, 16, 4))):
        form, plain, seeds, lens = walk
        tab = mw.seed_table(seeds, lens, 8)
        out = mw.chained_walk(form, tab)
        assert tab.shape[0] > 0 and bool((out["meets"] < 0).all())
        assert out["starts"].tolist() == [0]
        assert torch.equal(out["ins"], plain)
        stats = mw.chain_stats(tab, out["meets"], sum(lens) - 1)
        assert stats["chains"] == 1
        assert stats["longest_chain"] == sum(lens) - 1


def test_tiny_cycling_run_is_one_chain():
    """Phase 7's run of the documents [1], [2], [3], [1, 2] cycled (its
    pad runs tie every segment's tail): no seed meets, and the one chain
    crosses every segment boundary; 33 segments, where the kernel walks
    one chain anyway."""
    tiny = _operands([[1], [2], [3], [1, 2]], 6, 8, 4)
    fms = [tiny[i % 4] for i in range(33)]
    form, plain, seeds, lens = _kway_walk(fms)
    tab = mw.seed_table(bm._walk_seeds(fms[1:]), lens, 4)
    out = mw.chained_walk(form, tab)
    assert tab.shape[0] == 32 and bool((out["meets"] < 0).all())
    assert torch.equal(out["ins"], plain)
    assert bm._kway_walk_inputs(fms)[9] is None   # no seeds past 32 lanes


def test_seed_failing_at_its_segment_boundary():
    """Segments 1 and 2 the same document, so no seed of theirs meets: the
    seed at position stride of each walked segment has a window that ends
    at its segment's last step and fails there, and the chain before it
    walks on across the boundary; the ins still equal the plain walk's."""
    rng = np.random.default_rng(5)
    x, y = (rng.integers(1, 5, n).astype(np.int32) for n in (70, 50))
    fms = _operands([x, y, y], 6, 16, 4)
    form, plain, seeds, lens = _kway_walk(fms)
    tab = mw.seed_table(seeds, lens, 8)
    out = mw.chained_walk(form, tab)
    last = {1: sum(lens) - 1, 2: lens[1] - 1}          # segments' last steps
    at_end = [i for i, (_, _, wend, s) in enumerate(tab.tolist())
              if wend == last[s]]
    assert len(at_end) == 2
    assert all(int(out["meets"][i]) < 0 for i in at_end)
    assert torch.equal(out["ins"], plain)


def test_seed_meeting_before_its_segment_boundary():
    """Distinct documents: the seed at position stride of a walked segment
    meets inside its window, before the boundary, and hands over."""
    fms = _operands(_corpus_docs("dna", (300, 200, 120)), 6, 16, 4)
    form, plain, seeds, lens = _kway_walk(fms)
    tab = mw.seed_table(seeds, lens, 8)
    out = mw.chained_walk(form, tab)
    ends = {2: lens[1] - 1, 1: sum(lens) - 1}   # segments' last steps
    hits = [(int(out["meets"][i]), ends[s]) for i, (_, _, wend, s) in
            enumerate(tab.tolist()) if wend == ends[s]]
    assert len(hits) == 2 and any(0 <= m <= e for m, e in hits)
    assert all(m < 0 or m <= e for m, e in hits)
    assert torch.equal(out["ins"], plain)


# -- the plan, the grid and the seed table by hand ---------------------------

@pytest.mark.parametrize("steps, lanes, rate, warps, stride, slots, cpb", [
    # walk (a): DNA k-way k = 8 (8 lanes, 4 chains a warp), 4224 warps
    (1_966_527, 8, 32, 4224, 128, 16896, 16),
    # a pairwise walk of 2^20 steps: one chain a thread, 32 a warp
    (1 << 20, 1, 32, 4224, 32, 135168, 128),
    # few steps: the least stride, the SA rate
    (4095, 4, 32, 4224, 32, 33792, 32),
    # a card holding fewer chains than seeds at the rate: doubled
    (10_000, 32, 4, 1000, 12, 1000, 4),
    # no SA sample, or nothing to cut: one chain
    (1 << 20, 8, 0, 4224, 0, 16896, 16),
    (1, 1, 32, 4224, 0, 135168, 128),
])
def test_plan_by_hand(steps, lanes, rate, warps, stride, slots, cpb):
    assert mw.walk_plan(steps, lanes, rate, warps) == {
        "stride": stride, "slots": slots, "chains_per_block": cpb}


@pytest.mark.parametrize("n_seeds, lanes, grid", [
    (15_363, 8, 961), (32_767, 1, 256), (0, 1, 1), (0, 32, 1), (3, 32, 1),
    (4, 32, 2), (127, 2, 2)])
def test_grid_by_hand(n_seeds, lanes, grid):
    assert mw.walk_grid(n_seeds, lanes) == grid


@pytest.mark.parametrize("k, lanes", [(2, 2), (3, 4), (5, 8), (8, 8),
                                      (9, 16), (17, 32), (32, 32),
                                      (33, None), (1100, None)])
def test_chain_lanes(k, lanes):
    assert mw.chain_lanes(k) == lanes


def test_seed_table_by_hand():
    """Walked segments 1 and 2 of 10 and 7 rows (segment 2 walked first,
    steps 0-6, then segment 1, steps 7-16), SA rate 2, stride 4: segment 2
    has a seed at position 4 (step 2); segment 1 at 8 and 4 (steps 8, 12),
    the last window ending at the walk's last step; rows from the seeds'
    positions (segment 1's 5 sampled positions first)."""
    rows = torch.arange(100, 109, dtype=torch.int32)
    tab = mw.seed_table(mw.Seeds(rows, 2), [10, 7], 4)
    assert tab.tolist() == [[2, 107, 6, 2], [8, 104, 12, 1],
                            [12, 102, 16, 1]]
    # pairwise: one segment of 9 rows; position 8 is the anchor's step 0
    tab = mw.seed_table(mw.Seeds(torch.arange(5, dtype=torch.int32), 2),
                        [9], 4)
    assert tab.tolist() == [[4, 2, 8, 1]]
    with pytest.raises(ValueError, match="multiple of the SA sample rate"):
        mw.seed_table(mw.Seeds(rows, 4), [10, 7], 6)


@pytest.mark.parametrize("seed", range(6))
def test_seed_count_is_the_table_s(seed):
    """The count the kernel's grid is sized by (and the kernel derives
    each seed from) is the table's, anchor exclusion included."""
    rng = np.random.default_rng(seed)
    rate = int(rng.choice([1, 2, 4]))
    for _ in range(20):
        lens = [int(n) for n in rng.integers(1, 60, int(rng.integers(1, 5)))]
        stride = rate * int(rng.integers(1, 5))
        rows = torch.zeros(sum(-(-n // rate) for n in lens), dtype=torch.int32)
        tab = mw.seed_table(mw.Seeds(rows, rate), lens, stride)
        assert mw.seed_count(lens, stride) == tab.shape[0]
    assert mw.seed_count([9], 4) == 1 and mw.seed_count([9], 0) == 0


def test_chain_stats_by_hand():
    """Seeds at steps 10, 20, 30 (windows of 10); the first meets at 13,
    the second fails, the third meets at 36, the walk's last step 50:
    chains 0 -> 13, 10 -> 36 (the failed seed absorbed), 30 -> 50."""
    tab = torch.tensor([[10, 0, 20, 1], [20, 0, 30, 1], [30, 0, 40, 1]])
    meets = torch.tensor([13, -1, 36])
    assert mw.chain_stats(tab, meets, 50) == {
        "chains": 3, "seeds_met": 2, "seeds_tried": 3,
        "median_steps_to_meet": 4.5, "max_steps_to_meet": 6,
        "longest_chain": 26}


# -- the wrappers' C arguments ----------------------------------------------

def _c_params(entry: str) -> int:
    src = (_build.CSRC / "merge_walk.cu").read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    assert m, entry
    return len(m.group(1).split(","))


@pytest.mark.parametrize("entry", ["merge_walk", "merge_walk_kway"])
def test_declared_argument_types_match_the_source(entry):
    assert len(_build.SIGNATURES[entry]) == _c_params(f"{entry}_launch")


def test_occupancy_query_matches_the_source():
    assert len(mw.OCCUPANCY_ARGTYPES) == _c_params("merge_walk_occupancy")


@pytest.mark.parametrize("flavour", ["pairwise", "kway", "kway33"])
def test_wrapper_passes_what_the_entry_takes(monkeypatch, flavour):
    """The CUDA branch's C arguments, on CPU tensors with the dispatch and
    the card's occupancy stubbed: as many as the entry declares (with the
    stream), the seed table of the plan's stride and its row count, the
    report filled."""
    calls = []
    monkeypatch.setattr(mw, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(mw, "walk_occupancy", lambda *a: {
        "resident_warps": 2, "blocks_per_sm": 1, "sms": 1})
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args, entry=None: calls.append(
                            (entry or name, args)))
    docs = _corpus_docs("dna", (300, 200, 120))
    fms = _operands(docs, 6, 16, 4)
    report = {}
    if flavour == "pairwise":
        clf, ends = bm._pairwise_walk_inputs(fms[0], fms[1])
        mw.merge_walk(*bm._rank_rows(fms[0]), fms[0].c_array,
                      fms[1].c_array, clf, ends, bm._walk_seeds([fms[1]]),
                      report=report, **_kw(fms[0]))
        lanes, steps = 1, fms[1].length - 1
    else:
        if flavour == "kway33":
            fms = [fms[i % 3] for i in range(33)]
        mw.kway_walk(*bm._kway_walk_inputs(fms), report=report,
                     **_kw(fms[0]))
        lanes = mw.chain_lanes(len(fms))
        steps = sum(f.length for f in fms[1:]) - 1
    ((entry, args),) = calls
    assert len(args) + 1 == len(_build.SIGNATURES[entry])
    tab = report["seeds"]
    if lanes is None:
        assert report["plan"] == {"stride": 0, "n_seeds": 0, "grid": 1}
        assert tab.shape[0] == 0
    else:
        stride = mw.walk_plan(steps, lanes, 4, 2)["stride"]
        assert report["plan"]["stride"] == stride > 0
        assert tab.shape[0] == report["plan"]["n_seeds"] > 0
        assert tab.dtype == torch.int32
        assert report["plan"]["grid"] == mw.walk_grid(tab.shape[0], lanes)
        assert report["meets"].shape == (tab.shape[0],)
    assert args[-3] == tab.shape[0]      # table, n_seeds, meets, ins


# -- the planner under the card's cost constants ------------------------------

def _run(log2n, shape):
    """Stand-ins for a run's segments as the planner sizes them: one
    document of 2^(log2n - d) tokens each."""
    import types

    return [types.SimpleNamespace(n_tokens=1 << (log2n - d),
                                  docs=[(1 << (log2n - d), 0)])
            for d in shape]


@pytest.mark.parametrize("what, sigma, log2n, shape", [
    ("phase 7 / 8 DNA run", 6, 20, (0, 1, 1, 2, 2, 3, 3, 3)),
    ("phase 7 proteins run", 22, 19, (0, 1, 1, 2)),
])
def test_planner_picks_the_rebuild_under_the_card_constants(what, sigma,
                                                            log2n, shape):
    """With the card's constants (``configs/bwt_index.py``: the chained
    walk's per-step costs from chip_smoke phase 7) the splice and build
    alone cost more per token than the sort, so phase 7's and phase 8's
    runs still rebuild; and phase 8's appends (the same documents, largest
    first) trigger no compaction before the backstop's 8 segments."""
    from repro_torch.configs.bwt_index import CONFIG
    from repro_torch.core.segments import SegmentedIndex

    cat = SegmentedIndex.from_config(sigma, CONFIG, device="cpu")
    run = _run(log2n, shape)
    est = cat._est_costs(run)
    assert min(est, key=est.get) == "rebuild", (what, est)
    assert est["kway"] < est["pairwise"]
    for m in range(2, len(run)):
        est = cat._est_costs(run[:m])
        best = min(est["pairwise"], est["kway"])
        assert best > CONFIG.compact_trigger_cost_ratio * est["rebuild"]
        assert est["rebuild"] > CONFIG.compact_cost_merge_us * 1e3
