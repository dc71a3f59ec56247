"""The measurement helpers of chip_smoke.py (repo root), on fake profiler
rows: a per-call device time is a row's total over the launches the
profiler recorded for it, a row recorded too often or too rarely fails,
a profile that lost records is taken again, and no reading may be under
its bytes bound; phase 7's merge runs and phase 16 / 17's helpers at tiny
sizes.  No GPU and no profiler run.  The other phases' rehearsals live in
``test_torch_chip_smoke_<phase>.py`` (catalog, frontend, dist, lm,
lm_train, launch, train, unpacked), so that the suite's workers share
them.
"""

import types

import pytest
import torch
from torch_session_cache import load_chip_smoke
from torch.autograd import DeviceType


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# one module per process: the functions handed to spawned ranks must be the
# ones the ranks import by the name chip_smoke
chip_smoke = load_chip_smoke()


def test_per_call_divides_by_recorded_launches():
    """A 0.371 ms kernel whose profile kept 12 of 20 launches reads 0.371
    ms, not 0.371 * 12 / 20 = 0.223 ms (the division by ``reps``)."""
    got = chip_smoke.per_call_ms([("char_histogram_kernel", 371.0 * 12, 12),
                                  ("Memset (Device)", 1.2 * 20, 20)], 20)
    assert got["char_histogram_kernel"]["ms"] == pytest.approx(0.371)
    assert got["char_histogram_kernel"]["launches"] == 12
    assert got["Memset (Device)"]["ms"] == pytest.approx(0.0012)
    assert got["Memset (Device)"]["launches"] == 20


@pytest.mark.parametrize("count", [0, 9, 21, 40])
def test_recorded_launches_out_of_range_fail(count):
    """Each kernel name of a 20-call run must have been recorded 10 to 20
    times; a profile that lost most records or counted launches twice
    fails."""
    with pytest.raises(AssertionError, match="launches recorded"):
        chip_smoke.per_call_ms([("rerank_kernel", 1000.0, 20),
                                ("radix_pos_kernel", 50.0 * count, count)],
                               20)


@pytest.mark.parametrize("count", [10, 20])
def test_recorded_launches_at_the_edges_pass(count):
    got = chip_smoke.per_call_ms([("k", 2.0 * count, count)], 20)
    assert got["k"]["ms"] == pytest.approx(0.002)


def test_no_rows_fails():
    with pytest.raises(AssertionError, match="no profiler rows"):
        chip_smoke.per_call_ms([], 20)


@pytest.mark.parametrize("device_ms,ms", [(0.95, 1.2), (1.2, 0.95),
                                          (0.0, 0.0)])
def test_reading_under_its_bound_fails(device_ms, ms):
    with pytest.raises(AssertionError, match="under its bytes bound"):
        chip_smoke.check_reading("rerank_scan", device_ms, 0.9616, ms,
                                 "q-gram words")


def test_reading_at_or_over_its_bound_passes():
    chip_smoke.check_reading("rerank_scan", 0.9616, 0.9616, 1.04, "q-gram")
    chip_smoke.check_reading("rerank_scan", 1.04, 0.9616)


def test_the_impossible_reading_is_refused():
    """The char_histogram figure of the broken helper on the DNA 2^28 BWT:
    0.223 ms against a 0.3205 ms bound, 144% of the HBM peak."""
    with pytest.raises(AssertionError, match="char_histogram .*BWT"):
        chip_smoke.check_reading("char_histogram", 0.223, 0.3205, 0.377,
                                 "DNA n=268435456 BWT")


def _fake_profiles(monkeypatch, profiles):
    """torch.profiler.profile replaced by one that yields ``profiles`` in
    turn, each a list of (name, self device us, count) device rows."""
    taken = []

    class Profile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            rows = profiles[min(len(taken), len(profiles) - 1)]
            taken.append(rows)
            return [types.SimpleNamespace(
                key=k, self_device_time_total=t, count=c,
                device_type=DeviceType.CUDA) for k, t, c in rows]

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Profile())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return taken


def test_a_profile_that_lost_records_is_taken_again(monkeypatch):
    taken = _fake_profiles(monkeypatch, [
        [], [("rerank_kernel", 5.0, 3)],
        [("rerank_kernel", 20000.0, 20), ("Memset (Device)", 24.0, 20)]])
    got = chip_smoke.kernel_device_split(lambda: None,
                                         ("rerank_kernel", "Memset"))
    assert len(taken) == 3
    assert got["rerank_kernel"]["ms"] == pytest.approx(1.0)
    assert got["Memset (Device)"]["launches"] == 20


@pytest.mark.parametrize("rows,match", [
    ([], "no profiler rows"),
    ([("rerank_kernel", 5.0, 3)], "launches recorded"),
    ([("rerank_kernel", 80.0, 40)], "launches recorded"),
])
def test_profiles_that_stay_broken_fail(monkeypatch, rows, match):
    taken = _fake_profiles(monkeypatch, [rows])
    with pytest.raises(AssertionError, match=match):
        chip_smoke.kernel_device_split(lambda: None, "rerank_kernel")
    assert len(taken) == 5


def test_merge_walk_parity_runs_on_the_cpu():
    """Phase 7's parity helper at a tiny size: pairwise and k-way walks on
    both layouts (plain against plain here), every k-way merge and a
    40-segment run against the rebuild."""
    err, cases, times = chip_smoke.merge_walk_parity(
        "cpu", log2n=7, ks=(2, 3), many=40)
    assert err == 0 and times == {}
    assert cases[0] == "pairwise dna bits=4 steps=191"
    assert sum(c.startswith("k-way proteins") for c in cases) == 2
    assert cases[-1] == "k-way dna-like k=40 vs rebuild"


@pytest.mark.parametrize("kind,sig,log2n,shape,flavour", [
    ("dna", 6, 9, chip_smoke.DNA_RUN[:4], "kway"),
    ("dna", 6, 9, chip_smoke.DNA_RUN[:4], "pairwise"),
    ("proteins", 22, 8, chip_smoke.PROTEIN_RUN, "kway"),
])
def test_merge_run_on_the_cpu(kind, sig, log2n, shape, flavour):
    """Phase 7's merge paths at a tiny size on the CPU: each walk's ins
    equal to the suffix arrays' (the plain walks here), equal to the
    rebuild, the same answers, no kernel launched, walk steps as the JAX
    package counts them, and a latency bound of one load per step."""
    rec, launches = chip_smoke.merge_run(
        kind, sig, log2n, shape, flavour, device="cpu",
        latency_ns=lambda n: 0.0)
    assert set(launches.values()) == {0}
    k = len(shape)
    lens = rec["prepared"]
    assert rec["k"] == k and rec["merged_n"] == sum(lens)
    assert len(rec["stages"]) == (1 if flavour == "kway" else k - 1)
    if flavour == "kway":
        assert rec["steps"] == sum(lens[1:]) - 1
    else:   # the fold walks every accumulator: 1, 2, ... k-1 documents
        assert rec["steps"] == sum(sum(lens[i:]) - 1 for i in range(1, k))
    assert rec["bound_s"] == 0.0 and rec["fm_mismatch"] == []
    assert rec["ins_max_abs_err"] == 0


@pytest.mark.parametrize("flavour", ["kway", "pairwise"])
def test_merge_run_refuses_a_wrong_walk(monkeypatch, flavour):
    """A walk whose ins is off by one in one row fails the run on the
    suffix arrays' ins, before the spliced index is compared."""
    from repro_torch.core import bwt_merge as bm

    name = "kway_walk" if flavour == "kway" else "merge_walk"
    walk = getattr(bm, name)

    def off_by_one(*args, **kw):
        ins = walk(*args, **kw).clone()
        ins[len(ins) // 2] += 1
        return ins

    monkeypatch.setattr(bm, name, off_by_one)
    with pytest.raises(AssertionError,
                       match="differs from the rebuild's suffix arrays"):
        chip_smoke.merge_run("dna", 6, 8, (0, 1, 1), flavour, device="cpu")
    assert getattr(bm, name) is off_by_one    # observation restored it


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("descending", [False, True])
def test_expected_ins_by_hand(n, descending):
    """The suffix arrays' ins on a hand-checkable run of n + 1 one-token
    documents whose suffixes sort in text order (each walked suffix has
    every earlier document's before it) or in reverse (every later one's):
    k-way segment s gets s or n - s; every fold walk's rows all get 1 (the
    new left document sorts first) or 0."""
    import torch

    lens = [1] * (n + 1)
    sas = [torch.zeros(1, dtype=torch.int32)] * (n + 1)
    sa_u = torch.arange(n + 1, dtype=torch.int32)
    if descending:
        sa_u = sa_u.flip(0)
    (kway,) = chip_smoke.expected_ins("kway", sas, sa_u, lens)
    assert kway.tolist() == [n - s if descending else s
                             for s in range(1, n + 1)]
    fold = chip_smoke.expected_ins("pairwise", sas, sa_u, lens)
    assert [f.tolist() for f in fold] == [[0 if descending else 1] * (j + 1)
                                          for j in range(n)]


def test_merge_run_refuses_a_walk_under_its_bound():
    with pytest.raises(AssertionError, match="under its latency bound"):
        chip_smoke.merge_run("dna", 6, 8, (0, 1), "kway", device="cpu",
                             latency_ns=lambda n: 1e12)


def test_pointer_chase_source_declares_its_signature():
    """The pointer chase's C entry takes as many parameters as the
    argument types chip_smoke passes (a file read, no nvcc)."""
    import re

    src = chip_smoke.CHASE_SRC.read_text()
    m = re.search(r'extern "C" int pointer_chase_launch\(([^)]*)\)', src)
    assert m and len(m.group(1).split(",")) == len(chip_smoke.CHASE_ARGTYPES)


# -- phase 16: the english path at the config's sigma; phase 17: examples --

@pytest.mark.parametrize("count", [1024, 101, 4])
def test_bucket_patterns_fill_every_bucket(count):
    """An equal share of the requests in each of the config's buckets
    (the first buckets take the remainder), lengths from 3 up to the
    bucket and over the bucket below, each a substring of the text."""
    import numpy as np

    from repro_torch.configs.bwt_index import CONFIG
    from repro_torch.data.corpus import corpus

    toks = corpus("english", 1 << 14)
    buckets = CONFIG.serve_length_buckets
    pats = chip_smoke.bucket_patterns(toks, count, 16, buckets)
    assert len(pats) == count
    lo, start = 3, 0
    for i, hi in enumerate(buckets):
        share = count // len(buckets) + (i < count % len(buckets))
        lens = [len(p) for p in pats[start: start + share]]
        assert all(lo <= L <= hi for L in lens)
        lo, start = hi + 1, start + share
    text = toks.tobytes()
    assert all(p.astype(np.int32).tobytes() in text for p in pats)
    again = chip_smoke.bucket_patterns(toks, count, 16, buckets)
    assert all(np.array_equal(a, b) for a, b in zip(pats, again))


def test_brute_counts_by_hand():
    """Every position scanned: overlapping hits, the text's last tokens,
    patterns shorter and longer than the packed word, absent ones."""
    import numpy as np

    from repro_torch.data.corpus import corpus

    toks = corpus("english", 3000)
    toks[100:110] = 5
    pats = [np.array([5, 5]), np.array([5] * 4), np.array([5] * 7),
            toks[-3:], toks[-9:], toks[:64], np.array([7, 8, 9]),
            toks[200:205], np.array([33]), np.array([5] * 11)]

    def naive(p):
        L = len(p)
        return sum(np.array_equal(toks[i: i + L], p)
                   for i in range(len(toks) - L + 1))

    got = chip_smoke.brute_counts(torch.as_tensor(toks), pats)
    assert got == [naive(np.asarray(p, np.int32)) for p in pats]
    assert got[:3] == [9, 7, 4] and got[-1] == 0
    with pytest.raises(AssertionError, match=r"\[0, 128\)"):
        chip_smoke.brute_counts(torch.tensor([1, 200], dtype=torch.int32),
                                pats)


def test_english_rows_keep_locate_buckets_and_refuse_a_broken_one():
    fq = {"name": "fm_query_unpacked", "index": "english n=8",
          "max_abs_err": 0,
          "buckets": [dict(m=m, B=1024, k=k, ms=0.1, device_ms=0.08,
                           bound_ms=0.01, plain_ms=9.0, old_ms=1.0,
                           latency_floor_ms=0.05)
                      for m in (8, 16, 32, 64) for k in (0, 16)]}
    rows = chip_smoke.english_rows(fq)
    assert [r["m"] for r in rows["locate"]] == [8, 16, 32, 64]
    assert all(r["k"] == 16 for r in rows["locate"])
    fq["buckets"][-1]["device_ms"] = 0.001
    with pytest.raises(AssertionError, match="under its bytes bound"):
        chip_smoke.english_rows(fq)


def test_mesh_keeper_keeps_host_copies():
    class Index:
        sa = torch.arange(5, dtype=torch.int32)
        bwt = torch.ones(5, dtype=torch.int32)
        row = torch.tensor(3, dtype=torch.int32)

    store = {}
    chip_smoke.mesh_keeper(store)(Index)
    assert torch.equal(store["sa"], Index.sa) and store["row"] == 3
    assert store["sa"].device.type == "cpu"


def test_phase_examples_on_the_cpu(monkeypatch):
    """Phase 17's machinery on the CPU over the quickstart: its lines and
    its launches (none: plain versions); an example that does not end
    with its OK line fails the phase."""
    rec, launches = chip_smoke.phase_examples(
        "cpu", examples=(("torch_quickstart", ()),))
    lines = rec["examples"]["torch_quickstart"]["lines"]
    assert lines[0].startswith("bwt(BANANA$) = ANNB$AA   I = 4")
    assert lines[-1] == "quickstart OK"
    assert set(launches.values()) == {0}
    monkeypatch.setattr(chip_smoke, "run_example",
                        lambda name, argv: ["quickstart failed"])
    with pytest.raises(AssertionError, match="ended without"):
        chip_smoke.phase_examples("cpu", examples=(("torch_quickstart",
                                                    ()),))
