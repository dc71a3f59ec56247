"""The measurement helpers of chip_smoke.py (repo root), on fake profiler
rows: a per-call device time is a row's total over the launches the
profiler recorded for it, a row recorded too often or too rarely fails,
a profile that lost records is taken again, and no reading may be under
its bytes bound.  No GPU and no profiler run.
"""

import importlib.util
import sys
import types
from pathlib import Path

import pytest
import torch
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


_ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
# importable by name, as phase 10's spawned ranks import their function
sys.modules.setdefault("chip_smoke", chip_smoke)
if str(_ROOT) not in sys.path:
    sys.path.append(str(_ROOT))
_SPEC.loader.exec_module(chip_smoke)


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


# -- phase 8: the segmented catalog --------------------------------------

def test_bucket_bytes_at_the_catalog_scale():
    """Phase 8's buckets: DNA 2^28 in 16 segments (2^18 + 1 blocks each,
    15-word fused rows at r = 64, SA stride 32) is 0.50 GB of rows and
    0.20 GB of SA sample; a 17th segment doubles it (1.4 GB); proteins
    2^24 in 4 segments (r + sigma = 87 words per block)."""
    dna = chip_smoke.bucket_bytes(16, (1 << 18) + 1, 15, 64, 32)
    assert dna == {"seg_pad": 16, "blocks_pad": 1 << 19,
                   "rows": 503_316_480, "sa_sample": 201_326_592}
    grown = chip_smoke.bucket_bytes(17, (1 << 18) + 1, 15, 64, 32)
    assert grown["seg_pad"] == 32
    assert grown["rows"] + grown["sa_sample"] == 1_409_286_144
    assert chip_smoke.bucket_bytes(4, (1 << 16) + 1, 64 + 23, 64, 32) == {
        "seg_pad": 4, "blocks_pad": 1 << 17, "rows": 182_452_224,
        "sa_sample": 12_582_912}


def _small_catalog(pack, n_seg=3, seg_pad=None, compress_sa=False):
    import torch  # noqa: F401

    from repro_torch.core.fm_index import stack_fm_indexes
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus

    fms = [build_index(corpus("dna", 300 + 70 * i, seed=i), sample_rate=16,
                       sa_sample_rate=8, sigma=6, pack=pack,
                       compress_sa=compress_sa, device="cpu").fm
           for i in range(n_seg)]
    return fms, stack_fm_indexes(fms, seg_pad=seg_pad)


@pytest.mark.parametrize("pack", [None, False])
def test_built_bucket_matches_its_arithmetic(pack):
    fms, st = _small_catalog(pack)
    row_words = st.fused.shape[1] if st.bits else 16 + st.sigma
    assert chip_smoke.stacked_bucket_bytes(st) == chip_smoke.bucket_bytes(
        3, max(f.n_blocks for f in fms), row_words, 16, 8)


@pytest.mark.parametrize("pack", [None, False])
def test_stacked_bound_sums_the_segments(pack):
    """The stacked kernel's bytes bound over n_seg x B lanes: each
    segment's own bytes (``query_bytes`` of its view, equal to its index's
    with raw SA values), the patterns once, pad rows' outputs; its walk is
    the longest segment's."""
    from repro_torch.data.corpus import corpus

    fms, st = _small_catalog(pack, seg_pad=4)
    toks = corpus("dna", 300, seed=0)
    P = chip_smoke.pad_patterns(chip_smoke.sample_patterns(toks, 40, 1),
                                32, "cpu")
    for k in (0, 4):
        per = [chip_smoke.query_bytes(f, P, k) for f in fms]
        views = [chip_smoke.query_bytes(chip_smoke.segment_view(st, s), P, k)
                 for s in range(3)]
        assert views == per
        B = P.shape[0]
        want = (sum(b for b, _ in per) - 2 * 4 * P.numel()
                + 4 * (2 * B + B * k))
        assert chip_smoke.stacked_query_bytes(st, P, k) == (
            want, max(w for _, w in per))


def test_phase_catalog_runs_on_the_cpu():
    """Phase 8 at a tiny size on the CPU (plain versions, no launch): the
    catalog's checks pass (the 2-bit catalog's too), segment_min_tokens shrinks with the corpus, the
    growth compacts and the save -> load and second save pass; every
    bucket's edge cases (k = 0, 1, 16, 64) and n_seg views up to its own
    were held to the plain version; the card's records (the kernels-line
    rows, the 16-segment proteins sweep) are empty here."""
    from repro_torch.data.corpus import corpus

    rec, launches, rows = chip_smoke.phase_catalog(
        corpus("dna", 1 << 13), 11, 9, device="cpu", requests=32)
    dna, prot = rec["dna"], rec["proteins"]
    assert dna["segments"] == 16 and prot["segments"] == 4
    assert dna["bits"] == 4 and prot["bits"] == 0
    assert dna["max_abs_err"] == prot["max_abs_err"] == 0
    two_bit = rec["two_bit"]
    assert two_bit["bits"] == 2 and two_bit["max_abs_err"] == 0
    assert two_bit["seg_pad"] > two_bit["segments"]
    assert dna["growth"]["merges"] >= 1
    assert dna["forced_kway"]["fm_mismatch"] == []
    assert dna["save_load"]["second_save_files"] >= 1
    assert all(set(v.values()) == {0} for v in launches.values())
    assert rows == {"fm_query_stacked_packed": None,
                    "fm_query_stacked_unpacked": None}
    edge = ["edge k=0", "edge k=1", "edge k=16", "edge k=64"]
    for r, views in ((dna, [1, 2, 4, 8, 16]), (prot, [1, 2, 4]),
                     (two_bit, [1, 2, 4])):
        assert r["edge_cases"] == edge and r["views"] == views
    assert dna["row"] is None and "sweep" not in dna
    assert rec["proteins_16_segments"] is None


@pytest.mark.parametrize("pack", [None, False])
def test_latency_floor_by_hand(pack):
    """The longest pattern's symbols (PADs load nothing), then the walk's
    steps (one round trip a step packed, two unpacked) and the value, at
    the chase's latency over the bucket's row words."""
    import torch

    fms, st = _small_catalog(pack)
    P = torch.full((3, 8), -1, dtype=torch.int32)
    P[0, :5] = 1
    P[1, :7] = 2                       # the longest: 7 search steps
    P[2, :2] = 3
    seen = []

    def ns(words):
        seen.append(words)
        return 250.0

    floor = chip_smoke.latency_floor(st, P, 4, ns)
    per_step = 1 if st.bits else 2
    words = (st.fused.numel() if st.bits
             else st.blocks.numel() + st.occ.numel())
    assert seen == [words]
    assert floor["dependent_loads"] == 7 + 4 * per_step + 1
    assert floor["latency_floor_ms"] == pytest.approx(
        (7 + 4 * per_step + 1) * 250.0 / 1e6)
    count = chip_smoke.latency_floor(st, P, 0, ns)   # count: no walk
    assert count["dependent_loads"] == 7


def test_pre_redesign_launch_geometry_by_hand():
    """The replaced kernel's grid: 128-thread blocks over B x max(k, 1)
    lanes (packed) or B x 16 per 16 slots (unpacked), times seg_pad; waves
    over the card's resident blocks."""
    import types

    packed = types.SimpleNamespace(bits=4, seg_pad=16)
    unpacked = types.SimpleNamespace(bits=0, seg_pad=4)
    assert chip_smoke.lanes_blocks(packed, 1024, 16) == 2048
    assert chip_smoke.lanes_blocks(packed, 1024, 0) == 128
    assert chip_smoke.lanes_blocks(packed, 64, 16) == 128
    assert chip_smoke.lanes_blocks(unpacked, 1024, 16) == 512
    assert chip_smoke.lanes_blocks(unpacked, 1024, 17) == 1024
    assert chip_smoke.lanes_blocks(unpacked, 1024, 0) == 512
    assert chip_smoke.waves(2048, 10, 132) == pytest.approx(1.5515, 1e-4)


def test_pre_redesign_source_declares_its_signatures():
    """The pre-redesign kernel's C entries take as many parameters as the
    argument types chip_smoke passes (a file read, no nvcc)."""
    import re

    src = chip_smoke.LANES_SRC.read_text()
    for entry, types_ in chip_smoke.LANES_ARGTYPES.items():
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert m and len(m.group(1).split(",")) == len(types_), entry


def test_check_views_refuses_a_wrong_row(monkeypatch):
    """A kernel whose row of a real segment of a cut view differs from
    the plain version's fails; rows past the cut are not compared."""
    import torch

    fms, st = _small_catalog(None, seg_pad=4)
    P = torch.tensor([[1, 2, -1], [3, 1, -1]], dtype=torch.int32)
    name, kern, plain = chip_smoke.stacked_fns(st)

    def past_the_cut(v, P, k):
        sp, ep, pos = plain(v, P, k)
        sp = sp.clone()
        sp[v.n_seg:] += 1              # rows of pad segments: not compared
        return sp, ep, pos

    monkeypatch.setattr(chip_smoke, "stacked_fns",
                        lambda st: (name, past_the_cut, plain))
    assert chip_smoke.check_views(st, P, 2) == [1, 2]

    def wrong(v, P, k):
        sp, ep, pos = plain(v, P, k)
        return sp, ep + (v.n_seg == 2), pos

    monkeypatch.setattr(chip_smoke, "stacked_fns",
                        lambda st: (name, wrong, plain))
    with pytest.raises(AssertionError, match="n_seg=2 ep"):
        chip_smoke.check_views(st, P, 2)


def test_edge_cases_aim_at_the_walk_list():
    """All-PAD, every length-1 pattern, out-of-alphabet symbols and a cut
    from inside the second segment, padded to 128, at k = 0, 1, 16, 64."""
    import numpy as np
    import torch

    fms, st = _small_catalog(None)
    toks = [np.arange(1, 301, dtype=np.int32) % 5 + 1 for _ in range(3)]
    cases = chip_smoke.stacked_edge_cases(st, toks)
    assert [k for _, _, k in cases] == [0, 1, 16, 64]
    E = cases[0][1]
    assert E.shape[1] == 128 and bool((E[0] == -1).all())
    cut = torch.as_tensor(toks[1][150:190])
    assert any(bool((row[:40] == cut).all()) for row in E)


def test_kernels_line_lists_every_kernel_with_every_key():
    from repro_torch.kernels import _build

    rows = {name: dict(max_abs_err=0, ms=1.0, plain_ms=2.0, bound_ms=0.5,
                       library_ms=None, device_ms=0.9, shape="s")
            for name in _build.KERNELS}
    rows["fm_query_stacked_packed"]["dependent_steps"] = {"search": 32,
                                                         "walk": 32}
    launches = {name: 1 for name in _build.KERNELS}
    line = chip_smoke.kernels_line(rows, launches, {"catalog_dna": launches})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in line["kernels"]] == list(_build.KERNELS)
    for entry in line["kernels"]:
        assert keys <= set(entry)
        assert (chip_smoke.ROOT / entry["source"]).is_file()
        assert entry["replaces"].startswith("src/repro/kernels/")
    stacked = {k["name"]: k for k in line["kernels"]
               if "stacked" in k["name"]}
    assert {k["source"] for k in stacked.values()} == {
        "src/repro_torch/kernels/csrc/fm_query_stacked.cu"}
    assert stacked["fm_query_stacked_packed"]["dependent_steps"] == {
        "search": 32, "walk": 32}


# -- phase 9: the async frontend, the launcher's --serve-async, dedup -----

def _phase_frontend_cpu():
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus

    toks = corpus("dna", 1 << 13)
    index = build_index(toks, sample_rate=64, sa_sample_rate=32,
                        device="cpu")
    return chip_smoke.phase_frontend(
        index, toks, 20, device="cpu", requests=144, clients=4,
        launcher_log2n=12, dedup_log2n=12, plant_log2n=8)


def test_phase_frontend_runs_on_the_cpu():
    """Phase 9 at a tiny size on the CPU (plain versions, no launch):
    every scenario's answers equal the direct calls, the burst sheds, the
    faults resolve as specified, the live appends are seen, the launcher
    saves the appended catalog and dedup flags both planted copies."""
    rec, launches = _phase_frontend_cpu()
    single, cat = rec["single"], rec["catalog"]
    assert single["closed"]["completed"] == 144
    assert single["closed"]["rejected"] == 0
    assert single["overload"]["rejected"] > 0
    assert set(single["sync_flush_qps"]) == {"count", "locate"}
    faults = single["faults"]
    assert faults["worker_crash"]["worker_restarts"] == 1
    crash = faults["worker_crash"]
    assert crash["failed_first_flush"] >= 1
    assert crash["completed"] == 144 - crash["failed_first_flush"] >= 72
    assert faults["deadline"]["result"] == "DeadlineExceeded"
    assert faults["stop_pending"]["resolved"] == 144
    growth = cat["growth"]
    assert growth["appends"] == 8 and growth["compactions"] >= 1
    assert growth["requests_on_appended_text"] == 8 * (16 // 2)
    assert len(growth["append_s"]) == 8
    assert rec["launcher"]["reloaded_tokens"] == 4096 + 256
    assert rec["dedup"]["contaminated"] == 512
    assert rec["dedup"]["sampled_duplicates"] >= 1
    assert all(set(v.values()) == {0} for v in launches.values())
    for scenario in ("closed", "open", "overload"):
        assert {"count_p99_ms", "locate_p99_ms", "buckets"} <= set(
            single[scenario])


def test_phase_frontend_fails_on_a_future_that_raises(monkeypatch):
    """A dispatch error the worker catches into one flush's futures must
    fail the phase, not pass as answered requests."""
    import threading

    from repro_torch.serving.engine import FMQueryServer

    flush = FMQueryServer.flush
    calls = []

    def failing(self):
        if threading.current_thread() is not threading.main_thread():
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("device fault")
        return flush(self)

    monkeypatch.setattr(FMQueryServer, "flush", failing)
    with pytest.raises(AssertionError, match="futures raised"):
        _phase_frontend_cpu()
    assert len(calls) >= 3


@pytest.mark.parametrize("w", [2, 8, 32])
def test_window_counts_by_hand(w):
    """The brute-force window counts of phase 9's dedup check against a
    direct count of each window in the text."""
    import numpy as np

    rng = np.random.default_rng(w)
    toks = rng.integers(1, 5, 600).astype(np.int32)
    toks[400:460] = toks[10:70]
    starts = np.array([0, 10, 30, 400, 410, 600 - w])
    got = chip_smoke.window_counts(torch.as_tensor(toks), starts, w)
    want = [sum(np.array_equal(toks[i: i + w], toks[s: s + w])
                for i in range(len(toks) - w + 1)) for s in starts]
    assert got.tolist() == want


# -- phase 10: the distributed build and query ----------------------------

def _phase_dist_cpu(**kw):
    from repro_torch.data.corpus import corpus

    return chip_smoke.phase_dist(
        corpus("dna", 1 << 12), {}, dna_log2n=12, proteins_log2n=11,
        small_dna_log2n=11, small_proteins_log2n=10, device="cpu",
        parts=(2,), requests=32, launcher_log2n=12, **kw)


@pytest.fixture(scope="module")
def phase_dist_cpu():
    return _phase_dist_cpu()


RESTORE_PATHS = ("dist_restore_dist_on_one_device",
                 "dist_restore_dist_on_mesh", "dist_restore_fm_on_mesh",
                 "dist_p2_restore", "dist_restore_one_device")


def test_phase_dist_runs_on_the_cpu(phase_dist_cpu):
    """Phase 10 at a tiny size on the CPU (plain versions, no launch):
    every distributed build equals its single-device build and answers,
    one rank in this process and two in a gloo world; the overflowing
    samplesort start overflows and retries; the served batches make the
    reference's collectives (two psums a pattern position; locate adds
    two a walk step) and no other."""
    rec, launches, rows = phase_dist_cpu
    assert rec["transport_p1"] == rec["p2"]["transport"] == "gloo, direct"
    assert rows == {} and "nccl_two_ranks_one_card" not in rec
    assert all(set(v.values()) == {0} for v in launches.values())
    assert set(launches) == (
        {f"dist_p1_{k}" for k in ("dna", "dna_samplesort", "proteins")}
        | {f"dist_p2_{k}" for k in chip_smoke.dist_builds(11, 10)}
        | set(RESTORE_PATHS))
    paths = [rec["p1_dna"], rec["p1_dna_samplesort"], rec["p1_proteins"],
             *(rec["p2"][k] for k in chip_smoke.dist_builds(11, 10))]
    for r in paths:
        L = r["count"]["batch"][1]
        assert r["count"]["collectives"] == {
            "all_gather": 0, "gather": 0, "ppermute": 0, "all_to_all": 0,
            "psum": 2 * L, "pmax": 0}
        assert r["locate"]["collectives"]["psum"] == 2 * L + 2 * 32
        assert r["collectives_build"]["all_gather"] > 0
    assert rec["p1_dna_samplesort"]["collectives_build"]["all_to_all"] > 0
    assert rec["p2"]["dna_overflow"]["first_attempt_overflowed"] is True
    assert rec["p2"]["dna_overflow"]["capacity_factor"] == 0.5
    rounds = rec["p1_dna"]["isa_rounds"]
    assert rounds["remaining"][-1] == 0
    assert len(rounds["round_s"]) == len(rounds["remaining"]) - 1
    assert set(rec["p1_dna"]["stages_s"]) == {
        "prepare_tokens_host", "host_to_device", "isa", "bwt", "fm_build"}


def test_phase_dist_restores_on_the_cpu(phase_dist_cpu):
    """Phase 10's checkpoints at a tiny size on the CPU: (a) the one-rank
    DNA mesh index saved and restored on one device and onto the mesh,
    and a single-device checkpoint onto the mesh, each answering as the
    single-device build (checked inside), timed beside the mesh build;
    (b) the world's saved build restored in the world (the last one) and
    on one device; (c) the launcher as a world of 2, built and restored,
    with one total_hits printed by rank 0 alone."""
    rec, launches, _ = phase_dist_cpu
    p1 = rec["p1_restore"]
    assert p1["mesh_build_s"] == rec["p1_dna"]["build_s"]
    assert p1["save_s"] > 0 and p1["read_npz_s"] > 0
    assert p1["bytes_on_disk"] > 4 << 12
    L = rec["p1_dna"]["count"]["batch"][1]      # the requests' width
    for name in ("dist_on_one_device", "dist_on_mesh", "fm_on_mesh"):
        r = p1[name]
        assert r["restore_s"] > 0 and r["bits"] == 4
        assert r["peak_mem_gib"] is None
        mesh = name.endswith("mesh")
        # the mesh restore's symbol totals: one psum
        assert r["collectives_restore"]["psum"] == int(mesh)
        assert r["count"]["collectives"]["psum"] == 2 * L * mesh
    assert rec["p2"]["dna_bitonic"]["save_s"] > 0
    assert rec["p2"]["restore"]["collectives_restore"]["psum"] == 1
    assert rec["restore_one_device"]["collectives_restore"]["psum"] == 0
    built, restored = rec["launcher"]["build"], rec["launcher"]["restore"]
    assert built["total_hits"] == restored["total_hits"] > 0
    assert built["located"] == restored["located"] > 0
    assert any("2 ranks (gloo)" in line for line in built["lines"])
    assert any("restored dist_fm index" in line
               for line in restored["lines"])


def test_check_restored_refuses_any_difference():
    import numpy as np

    ref = dict(counts=np.ones(4), pos=np.zeros((4, 2)), cnt=np.ones(4))
    got = chip_smoke._host_answers(*ref.values())
    chip_smoke.check_restored(got, ref, "same")
    for key in ref:
        bad = dict(got, **{key: got[key] + 1})
        with pytest.raises(AssertionError, match=f"{key} differ"):
            chip_smoke.check_restored(bad, ref, "x")


def test_restore_launches_required_on_the_card_only():
    """On the card a restore launches char_histogram and its queries the
    rank kernel of a mesh index (the fused kernel on one device); on the
    CPU nothing launches."""
    zero = dict.fromkeys(("char_histogram", "rank_packed", "rank_select",
                          "fm_query_packed"), 0)
    rec = {"bits": 4, "launches_restore": dict(zero, char_histogram=1),
           "launches_queries": dict(zero, rank_packed=64)}
    chip_smoke.require_restore_launches(rec, object(), True, "ok")
    with pytest.raises(AssertionError, match="fm_query_packed never"):
        chip_smoke.require_restore_launches(rec, None, True, "x")
    with pytest.raises(AssertionError, match="char_histogram never"):
        chip_smoke.require_restore_launches(
            dict(rec, launches_restore=zero), object(), True, "x")
    with pytest.raises(AssertionError, match="launched on the CPU"):
        chip_smoke.require_restore_launches(rec, object(), False, "x")
    chip_smoke.require_restore_launches(
        dict(rec, launches_restore=zero, launches_queries=zero), None,
        False, "ok")


def failing_dist_rank(mesh, spec):
    """``chip_smoke.dist_rank`` on every rank but rank 1, which raises."""
    if mesh.get_local_rank("parts") == 1:
        raise RuntimeError("rank 1 lost its card")
    return chip_smoke.dist_rank(mesh, spec)


def test_phase_dist_fails_when_a_rank_raises():
    """A rank's exception fails the phase with that rank's traceback (the
    script then exits nonzero); the waiting rank does not hang it."""
    with pytest.raises(RuntimeError, match="rank 1 raised") as err:
        _phase_dist_cpu(rank_fn=failing_dist_rank)
    assert "rank 1 lost its card" in str(err.value)


def test_same_dist_refuses_any_difference():
    import numpy as np

    ref = dict(sa=np.arange(8), bwt=np.arange(8) % 3, row=2,
               counts=np.ones(4), pos=np.zeros((4, 2)), cnt=np.ones(4))
    rec = dict(ref)
    chip_smoke.same_dist(rec, *ref.values(), "same")
    for key, bad in (("sa", np.arange(8)[::-1]), ("row", 3),
                     ("cnt", np.zeros(4))):
        with pytest.raises(AssertionError, match="differ"):
            chip_smoke.same_dist({**rec, key: bad}, *ref.values(), "x")


def test_dist_launches_required_on_the_card_only():
    need = dict.fromkeys(chip_smoke.DIST_NEEDED["dna"], 1)
    chip_smoke.require_dist_launches({**need, "rerank_scan": 0}, "dna",
                                     True, "ok")
    with pytest.raises(AssertionError, match="rank_packed never launched"):
        chip_smoke.require_dist_launches({**need, "rank_packed": 0}, "dna",
                                         True, "x")
    with pytest.raises(AssertionError, match="launched on the CPU"):
        chip_smoke.require_dist_launches(need, "dna", False, "x")


def test_phase_lm_runs_on_the_cpu():
    """Phase 11 (a) at its size on the CPU for two reduced configs (GQA at
    S = 2048 through the chunked path, and MoE + MLA), no full-width part:
    the CPU against itself agrees and no index kernel launches."""
    rec, launches = chip_smoke.phase_lm(
        device="cpu", archs=["qwen2p5_3b", "deepseek_v2_236b"], full=False)
    qwen, ds = (rec["reduced_configs"][a] for a in ("qwen2p5_3b",
                                                    "deepseek_v2_236b"))
    assert qwen["forward_S2048_err"] == 0 and qwen["decode_err"] == 0
    assert ds["tol"] == chip_smoke.LM_MOE_TOL and "forward_S2048_err" not in ds
    assert qwen["generate_rows_differ"] == ds["generate_rows_differ"] == 0
    assert set(launches.values()) == {0}


def test_phase_lm_fails_on_a_mismatch(monkeypatch):
    """Weights that differ on the 'card' fail the phase."""
    carry = chip_smoke.on_device

    def skewed(params, device):
        out = carry(params, device)
        out["lm_head"] = out["lm_head"] * 1.01
        return out

    monkeypatch.setattr(chip_smoke, "on_device", skewed)
    with pytest.raises(AssertionError, match="differs from the CPU"):
        chip_smoke.phase_lm(device="cpu", archs=["minitron_4b"], full=False)


def test_generated_tokens_may_differ_only_at_a_tie():
    import numpy as np

    want = np.array([[1, 2, 3, 4]], np.int32)
    logits = torch.zeros(1, 3, 8)
    logits[0, 1, 3] = 1.0          # step 1 -> token 3, a clear winner
    logits[0, 2, 4] = logits[0, 2, 5] = 1.0   # step 2: a tie of 4 and 5
    got = want.copy()
    got[0, 3] = 5
    assert chip_smoke.tokens_agree(got, want, logits, 1, 1e-4, "t") == 1
    got[0, 2:] = [6, 7]
    with pytest.raises(AssertionError, match="top-2"):
        chip_smoke.tokens_agree(got, want, logits, 1, 1e-4, "t")


def test_single_query_parity_runs_on_the_cpu():
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus

    toks = corpus("proteins", 1 << 13)
    index = build_index(toks, device="cpu")
    rec, launches = chip_smoke.api_parity(toks, index, index)
    assert rec["rank_kernel"] == "rank_select" and rec["rpgi_n"] == 4097
    assert set(launches.values()) == {0}


@pytest.mark.parametrize("arch,layers,check", [("minitron_4b", None, 8),
                                               ("deepseek_v2_236b", 2, 0),
                                               ("mamba2_1p3b", None, 0)])
def test_lm_full_part_runs_on_the_cpu(monkeypatch, arch, layers, check):
    """A full-width part's logic at a reduced width on the CPU: bf16
    weights, generate, the timed forward and decode against forward."""
    from repro_torch.configs import base

    monkeypatch.setattr(base, "get_config", base.get_reduced_config)
    rec = chip_smoke.lm_full(arch, arch, layers, (2, 8, 4), (1, 16), check,
                             "cpu")
    assert rec["generate"]["steps"] == 11 and rec["generate"]["new"] == 4
    assert rec["forward"]["seq"] == 16
    assert ("reduced" in rec) == (layers is not None)
    assert ("capacity" in rec["forward"]) == (arch == "deepseek_v2_236b")
    if check:
        assert rec["decode_vs_forward"]["positions"] == check


def test_phase_lm_world_runs_on_the_cpu():
    """Phase 14 (a) on the CPU for a dense and an MoE config: each world
    (4 ranks, and 8 for the MoE config) on the 'card' (the CPU here)
    against the same world on the CPU agrees exactly; no index kernel
    launches in any rank."""
    rec, launches, _ = chip_smoke.phase_lm_world(
        device="cpu", archs=["qwen2p5_3b", "deepseek_v2_236b"], full=False)
    four, eight = rec["reduced"]["4_ranks"], rec["reduced"]["8_ranks"]
    assert four["transport"] == eight["transport"] == "gloo, direct"
    assert four["mesh"] == {"pod": 1, "data": 2, "model": 2}
    assert "qwen2p5_3b" not in eight
    for r in (four["qwen2p5_3b"], four["deepseek_v2_236b"],
              eight["deepseek_v2_236b"]):
        assert r["forward_err"] == r["decode_err"] == 0
        assert r["generate_rows_differ"] == 0
    assert four["deepseek_v2_236b"]["tol"] == chip_smoke.LM_MOE_TOL
    assert four["collectives_rank0"]["psum"] > 0
    assert set(launches.values()) <= {0}


def test_lm_world_full_parts_run_on_the_cpu():
    """Phase 14 (b) / (c)'s logic on reduced configs: the single-rank runs,
    then both parts in one world of (1, 1, 2), each rank holding half the
    heads (and experts) and half the positions of every attention cache,
    its forward and its decode logits along the single run's tokens
    against the single run's, and its greedy tokens equal; (c)'s MLA
    decodes over its latent cache split by sequence, one all_gather of
    the folded q heads and one of the partials a layer."""
    parts = (("minitron_4b", "minitron_4b", None, "float32", (2, 16),
              (2, 4, 4)),
             ("deepseek_v2_236b", "deepseek_v2_236b", 2, "bfloat16",
              (2, 16), (2, 4, 4)))
    rec, launches = chip_smoke.lm_world_full("cpu", parts,
                                             "get_reduced_config")
    m, d = rec["minitron_4b"], rec["deepseek_v2_236b"]
    assert rec["mesh"] == {"pod": 1, "data": 1, "model": 2}
    assert m["generate_rows_differ"] == 0
    assert m["forward_max_err"] <= chip_smoke.LM_TOL * (1 + m["max_abs_logit"])
    assert m["decode_max_err"] <= chip_smoke.LM_TOL * (
        1 + m["decode_max_abs_logit"])
    assert [r["local_heads"] for r in m["ranks"]] == [2, 2]
    gen = m["ranks"][0]["generate"]
    assert gen["steps"] == 7 and gen["collectives_per_step"]["psum"] > 0
    assert [r["local_experts"] for r in d["ranks"]] == [4, 4]
    assert d["forward_max_err"] <= chip_smoke.LM_BF16_TOL * d["max_abs_logit"]
    assert 0 < d["decode_max_abs_logit"]
    assert d["decode_max_err"] <= (chip_smoke.LM_BF16_TOL
                                   * d["decode_max_abs_logit"])
    assert d["generate_rows_differ"] <= 2
    # every MLA layer (one of the two reduced layers is MLA + MoE, the
    # other MLA + the dense FFN) gathers twice a step on top of the psums
    per = d["ranks"][0]["generate"]["collectives_per_step"]
    assert per["all_gather"] >= 2 * 2
    assert set(launches.values()) <= {0}


def test_phase_lm_train_runs_on_the_cpu():
    """Phase 15 on the CPU: (a) phase 14 (a)'s worlds with their train
    steps (a dense config also compressed, an MoE config in 4 and 8
    ranks), the 'card' (the CPU here) against the CPU exactly; (b) the
    world of (1, 2, 2) training a 2-layer reduced qwen2p5_3b for 3 steps
    against one rank, its checkpoint of step 2 restored and step 3 taken
    again bit for bit, with the collectives of a step by kind and pass;
    no index kernel launches in any rank."""
    spec = dict(chip_smoke.LM_TRAIN_WORLD, config="get_reduced_config",
                layers=2, seq=16)
    rec, launches = chip_smoke.phase_lm_train(
        "cpu", archs=["qwen2p5_3b", "deepseek_v2_236b"], spec=spec)
    four, eight = rec["reduced"]["4_ranks"], rec["reduced"]["8_ranks"]
    assert set(four) == {"mesh", "qwen2p5_3b", "qwen2p5_3b_compressed",
                         "deepseek_v2_236b"}
    assert set(eight) == {"mesh", "deepseek_v2_236b"}
    for r in (four["qwen2p5_3b"], four["qwen2p5_3b_compressed"],
              four["deepseek_v2_236b"], eight["deepseek_v2_236b"]):
        assert r["grad_err"] == r["state_err"] == r["loss_fn_err"] == 0
    assert four["qwen2p5_3b_compressed"]["ties"] >= 0
    full = rec["full"]
    assert full["resumed_bitwise"] and len(full["losses"]) == 3
    assert full["loss_max_err"] <= chip_smoke.LM_TOL * 10
    per = full["collectives_per_step"]
    assert per["all_gather/forward"] == per["all_gather/remat"] == \
        per["reduce_scatter/backward"] > 0
    assert per["psum/forward"] == per["psum/backward"] > 0
    assert per["psum/grads"] > 0 and per["psum/norm"] == 2
    assert full["checkpoint_bytes"] > 0
    assert set(launches.values()) <= {0}



# --------------------------------------------------------------------------
# phase 13's production mesh cells and the world peaks it holds
# --------------------------------------------------------------------------

def _mesh_cell(**kw):
    rec = {"counts": {"flops": 10, "bytes": 20}, "split_axes": ["model"],
           "collectives": {"moved_bytes": 30}}
    rec.update(kw)
    return rec


def test_check_mesh_cell_refuses_broken_readings():
    """A traced mesh cell that counts no work, or whose collectives move
    nothing where its rules split a weight over an axis, fails; a cell
    whose rules split nothing may move nothing."""
    chip_smoke.check_mesh_cell(_mesh_cell(), "ok")
    chip_smoke.check_mesh_cell(
        _mesh_cell(split_axes=[], collectives={"moved_bytes": 0}), "unsplit")
    with pytest.raises(AssertionError, match="move 0 bytes"):
        chip_smoke.check_mesh_cell(
            _mesh_cell(collectives={"moved_bytes": 0}), "silent")
    with pytest.raises(AssertionError, match="no FLOPs or bytes"):
        chip_smoke.check_mesh_cell(
            _mesh_cell(counts={"flops": 0, "bytes": 20}), "idle")


def test_mesh_cells_all_80_on_the_cpu(tmp_path, monkeypatch):
    """Phase 13's mesh checks over every cell (``dryrun.main --multi-pod
    both``, the separate command) at reduced configs and shorter
    sequences: 32 traced and 8 skipped per mesh, the four bwt_index cells
    traced at n = 2^16 and passing phase 13's index checks, each traced
    cell moving collective bytes; a cell whose step gathers nothing where
    its rules split a weight, or traced where the reference skips it, is
    refused."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.configs.bwt_index import reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import SHAPES

    for name, seq in (("train_4k", 64), ("prefill_32k", 256),
                      ("decode_32k", 128), ("long_500k", 256)):
        monkeypatch.setitem(SHAPES, name, dict(SHAPES[name], seq_len=seq))
    recs = dryrun.main(["--out", str(tmp_path), "--multi-pod", "both"],
                       config_of=get_reduced_config,
                       index_cfg=reduced().replace(n=1 << 16))
    lm = [r for r in recs if r["arch"] != "bwt_index"]
    out = chip_smoke.check_mesh_cells(lm, get_reduced_config)
    assert len(out) == chip_smoke.LAUNCH_MESH_CELLS
    traced = [v for v in out.values() if v["status"] == "traced"]
    assert len(traced) == 64
    assert all(v["collective_bytes"] > 0 and v["flops"] > 0 for v in traced)
    assert {v["chips"] for v in traced} == {256, 512}
    assert len(list(tmp_path.glob("*__16x16.json"))) == 42
    index = [r for r in recs if r["arch"] == "bwt_index"]
    assert [tuple(r[k] for k in ("arch", "shape", "mesh")) for r in index
            ] == list(chip_smoke.INDEX_MESH_CELLS)
    assert [r["status"] for r in index] == ["traced"] * 4
    summary = chip_smoke.check_index_mesh_cells(index)
    assert {v["chips"] for v in summary.values()} == {256, 512}
    assert all(v["collective_bytes"] > 0 for v in summary.values())
    # a world step whose collectives moved nothing is not the sharded
    # step; a cell traced where the reference skips it is refused
    rec = dryrun.run_cell("qwen2p5_3b", "decode_32k", mesh="16x16",
                          config_of=get_reduced_config)
    chip_smoke.check_mesh_cells([rec], get_reduced_config)
    rec["collectives"]["moved_bytes"] = 0
    with pytest.raises(AssertionError, match="move 0 bytes"):
        chip_smoke.check_mesh_cells([rec], get_reduced_config)
    with pytest.raises(AssertionError, match="long_500k x 16x16: traced"):
        chip_smoke.check_mesh_cells([dict(rec, shape="long_500k")],
                                    get_reduced_config)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen2p5_3b", "decode_32k", "16x16"),
    ("deepseek_v2_236b", "decode_32k", "2x16x16"),
    ("recurrentgemma_2b", "long_500k", "16x16")])
def test_check_mesh_cells_refuses_a_cache_not_in_the_references_layout(
        arch, shape, mesh):
    """Phase 13 on a decode cell (reduced configs, the shape's own
    sequence): the rank's attention caches hold what the reference's
    layout gives it (the sequence over model), which passes; a record
    whose rank holds more (the whole sequence, as a world that splits the
    kv heads instead would) is refused."""
    import copy

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(arch, shape, mesh=mesh,
                          config_of=get_reduced_config)
    got = rec["attention_cache_bytes"]
    assert got["held"] == got["argument"] > 0
    chip_smoke.check_mesh_cells([rec], get_reduced_config)
    whole = copy.deepcopy(rec)
    whole["attention_cache_bytes"]["held"] *= 16
    with pytest.raises(AssertionError, match="attention cache"):
        chip_smoke.check_mesh_cells([whole], get_reduced_config)


def test_check_index_mesh_cells_refuses_broken_readings():
    """An index mesh cell that is not traced, counts none of its kernels'
    bytes, moves no collective bytes or does not fit one card fails."""
    def cell(shape="build", **kw):
        rec = {"arch": "bwt_index", "shape": shape, "mesh": "16x16",
               "status": "traced", "chips": 256, "part_size": 4,
               "argument_bytes": {}, "held_argument_bytes": {},
               "trace_s": 0.1,
               "counts": {"bytes": 9, "kernel_bytes": {
                   "radix_hist": 1, "radix_pos": 2, "rank_select": 3}},
               "collectives": {"moved_bytes": 8, "calls": {"psum": 1}},
               "memory": {"fits": True, "temp_size_in_bytes": 1,
                          "total_bytes": 2},
               "roofline": {"memory_s": 1.0, "collective_s": 0.5,
                            "bottleneck": "memory"}}
        rec.update(kw)
        return rec

    out = chip_smoke.check_index_mesh_cells([cell(), cell("serve")])
    assert sorted(out) == ["bwt_index__build__16x16",
                           "bwt_index__serve__16x16"]
    for bad, match in (
            (cell(status="failed", error="boom"), "failed"),
            (cell(counts={"bytes": 1, "kernel_bytes": {"radix_hist": 1}}),
             "no radix_pos bytes"),
            (cell("serve", counts={"bytes": 1, "kernel_bytes": {}}),
             "no rank_select bytes"),
            (cell(collectives={"moved_bytes": 0, "calls": {}}),
             "move 0 bytes"),
            (cell(memory={"fits": False, "temp_size_in_bytes": 1,
                          "total_bytes": 2}), "does not fit")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_index_mesh_cells([bad])


def test_index_peaks_are_held_to_their_meta_estimates():
    """(a) phase 13's one-rank build peak and (b) the largest of phase 10
    (b)'s build peaks a rank in its world of 4, against ISA builds traced
    in meta worlds of 1 and 4 (small texts) for ``INDEX_PEAK_ROUNDS``
    rounds, whose peak is the whole budget's: from 0.90 to 1.10 x the
    estimate passes, outside it fails, and a reading the CPU does not
    take (None) is not held."""
    from repro_torch.configs.bwt_index import CONFIG, reduced
    from repro_torch.launch import dryrun

    est = {"isa_one_rank": chip_smoke.isa_estimate(1, reduced()),
           "isa_world": chip_smoke.isa_estimate(
               4, None, "proteins", 12)}
    one, world = est["isa_one_rank"], est["isa_world"]
    assert (one["parts"], one["n"], one["kind"]) == (1, 1 << 12, "english")
    assert world["parts"] == chip_smoke.INDEX_PEAK_WORLD[1] == 4
    assert world["n"] == (1 << 12) + 256 and world["sigma"] == 23
    for e in (one, world):
        assert e["total_bytes"] == e["argument_bytes"] + e["temp_bytes"] > 0
        assert e["rounds_traced"] > 0
    assert world["collective_bytes"] > 0
    for e, icfg in ((one, reduced()),
                    (world, CONFIG.replace(n=world["n"],
                                           sigma=world["sigma"]))):
        full = dryrun.trace_index_mesh_cell("build", e["parts"], icfg)
        assert e["rounds_traced"] == chip_smoke.INDEX_PEAK_ROUNDS
        assert full["rounds_traced"] > chip_smoke.INDEX_PEAK_ROUNDS
        assert e["total_bytes"] == full["memory"]["total_bytes"]
    got = chip_smoke.check_index_peaks(
        est, 1.1 * one["total_bytes"],
        [0.5 * world["total_bytes"], world["total_bytes"]])
    assert got["isa_one_rank"]["ratio"] == pytest.approx(1.1)
    assert got["isa_world"]["ratio"] == pytest.approx(1.0)
    assert len(got["isa_world"]["measured_bytes_per_rank"]) == 2
    assert chip_smoke.check_index_peaks(est, None, None) == {}
    with pytest.raises(AssertionError, match="one-rank build peak"):
        chip_smoke.check_index_peaks(est, 1.11 * one["total_bytes"], None)
    with pytest.raises(AssertionError, match="world of 4"):
        chip_smoke.check_index_peaks(est, None,
                                     [1.2 * world["total_bytes"]])
    with pytest.raises(AssertionError, match="one-rank build peak.* under"):
        chip_smoke.check_index_peaks(est, 0.89 * one["total_bytes"], None)
    with pytest.raises(AssertionError, match="world of 4"):
        chip_smoke.check_index_peaks(est, None,
                                     [0.8 * world["total_bytes"]])


def test_world_peaks_are_held_to_their_meta_estimates():
    """Phases 14 (b) and 15 (b) traced for rank 0 in meta worlds (reduced
    configs): a measured step peak from 0.90 to 1.10 x the estimate
    passes, one outside it fails."""
    est = chip_smoke.world_peak_estimates("get_reduced_config")
    train, serve = est["lm_world_train"], est["lm_world_full"]
    assert train["mesh"] == chip_smoke.LM_TRAIN_WORLD["mesh"]
    assert serve["mesh"] == chip_smoke.LM_WORLD_FULL_MESH
    assert serve["kind"] in ("prefill", "decode")
    assert serve["total_bytes"] >= serve["other_total_bytes"]
    for e in (train, serve):
        assert e["total_bytes"] == e["argument_bytes"] + e["temp_bytes"] > 0
        assert e["collective_bytes"] > 0
    gib = 2**30

    def records(t, s):
        served = {serve["arch"]: {"ranks": [
            {"step_peak_gib": s * serve["total_bytes"] / gib},
            {"step_peak_gib": 0.5 * serve["total_bytes"] / gib}]}}
        trained = {"step_peak_gib_per_rank": [
            t * train["total_bytes"] / gib, 0.0]}
        return served, trained

    got = chip_smoke.check_world_peaks(est, *records(1.0, 1.1))
    assert got["lm_world_full"]["ratio"] == pytest.approx(1.1)
    assert got["lm_world_train"]["ratio"] == pytest.approx(1.0)
    assert chip_smoke.check_world_peaks(est, None, None) == {}
    for t, s, match in ((1.0, 1.11, "phase 14"), (1.2, 1.0, "phase 15"),
                        (1.0, 0.89, "phase 14 .* under"),
                        (0.85, 1.0, "phase 15 .* under")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_world_peaks(est, *records(t, s))


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
