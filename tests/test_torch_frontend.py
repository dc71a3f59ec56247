"""The port's async serving frontend (``repro_torch/serving/frontend.py``)
and the launcher's ``--serve-async`` against the JAX package: every case of
``tests/test_serve_frontend.py`` runs the same numpy-seeded requests
through the JAX frontend and the port's (on the CPU).  Results (counts,
located positions, ``Rejected`` / ``DeadlineExceeded`` / ``Shutdown``),
the ``metrics()`` keys and bucket keys and the deterministic counters must
be equal: every output is an integer or a marker, so the tolerance is
exact equality.  Where timing decides which requests a flush takes (a
burst into a small queue, a crash of the first flush), each package is
held to the same invariants and every answer it gives to the direct
answer, which is the same in both.

Every ``Future.result`` takes a timeout, so a hang fails one test.
"""

import threading
import time
import types

import numpy as np
import pytest

from repro.core.fm_index import PAD, count_naive
from repro.core.pipeline import build_index as j_build_index
from repro.core.segments import SegmentedIndex as JSeg
from repro.serving import engine as j_engine
from repro.serving import frontend as j_frontend
from repro.testing import faultinject as j_fi
from repro_torch.core.pipeline import build_index as t_build_index
from repro_torch.core.segments import SegmentedIndex as TSeg
from repro_torch.serving import engine as t_engine
from repro_torch.serving import frontend as t_frontend
from repro_torch.testing import faultinject as t_fi

SIGMA = 5  # dna-like: tokens 1..4
WAIT = 60  # seconds any future may take

JAX = types.SimpleNamespace(
    name="jax", fe=j_frontend, fi=j_fi,
    server=lambda index, **kw: j_engine.FMQueryServer(index, **kw),
    seg=lambda *a, **kw: JSeg(*a, **kw))
TORCH = types.SimpleNamespace(
    name="torch", fe=t_frontend, fi=t_fi,
    server=lambda index, **kw: t_engine.FMQueryServer(index, device="cpu",
                                                      **kw),
    seg=lambda *a, **kw: TSeg(*a, device="cpu", **kw))
PKGS = (JAX, TORCH)

# the counters two runs of one deterministic workload must share
COUNTERS = ("admitted", "rejected", "completed", "appends", "compactions",
            "worker_restarts", "quarantined_segments", "deadline_exceeded")


@pytest.fixture(scope="module")
def built():
    """(toks, {package name: index}) over the same seeded tokens."""
    rng = np.random.default_rng(7)
    toks = rng.integers(1, SIGMA, 2000).astype(np.int32)
    kw = dict(sample_rate=16, sa_sample_rate=8)
    return toks, {"jax": j_build_index(toks, **kw),
                  "torch": t_build_index(toks, device="cpu", **kw)}


def _server(pkg, index, **kw):
    kw.setdefault("length_buckets", (4, 8))
    kw.setdefault("max_batch", 16)
    kw.setdefault("locate_k", 4)
    return pkg.server(index, **kw)


def outcome(fut):
    """A resolved future as comparable data: (marker or "answer", kind,
    count, positions) or ("raised", exception type name)."""
    try:
        r = fut.result(timeout=WAIT)
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return ("raised", type(e).__name__)
    if type(r).__name__ in ("Rejected", "DeadlineExceeded", "Shutdown"):
        return (type(r).__name__, r.kind, r.reason)
    pos = None if r.positions is None else np.asarray(r.positions).tolist()
    return ("answer", r.kind, int(r.count), pos)


def same_metrics(mj, mt, counters=COUNTERS):
    assert set(mt) == set(mj)
    assert set(mt["buckets"]) == set(mj["buckets"])
    for key in mt["buckets"]:
        assert set(mt["buckets"][key]) == set(mj["buckets"][key])
        assert mt["buckets"][key]["completed"] == \
            mj["buckets"][key]["completed"]
    for name in counters:
        assert mt[name] == mj[name], name


def requests(seed, toks, count, lo=2, hi=9, locate_frac=0.5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        L = int(rng.integers(lo, hi))
        st = int(rng.integers(0, len(toks) - L))
        out.append((toks[st: st + L],
                    "locate" if rng.random() < locate_frac else "count"))
    return out


def direct(toks, reqs, k=4):
    """The expected outcome of each request: counts by the naive oracle,
    located positions the sorted occurrences when at most k (which k of
    more follows SA order: the two packages then agree with each other,
    held in the tests)."""
    out = []
    for pat, kind in reqs:
        c = count_naive(toks, pat)
        if kind == "count":
            out.append(("answer", "count", c, None))
        else:
            occ = [i for i in range(len(toks) - len(pat) + 1)
                   if np.array_equal(toks[i: i + len(pat)], pat)]
            out.append(("answer", "locate", min(c, k),
                        occ if c <= k else None))
    return out


def assert_direct(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if g[0] == "Rejected":
            continue
        assert g[:3] == w[:3], i
        if w[3] is not None:
            assert g[3] == w[3], i


class TestServerEdges:
    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_empty_flush(self, built, pkg):
        _, idx = built
        server = _server(pkg, idx[pkg.name])
        assert server.flush() == {}
        assert server.stats.queries == 0 and server.stats.batches == 0

    def test_query_longer_than_any_bucket(self, built):
        """Oversize patterns escalate to the next pow2 bucket instead of
        truncating: both packages equal the naive oracle."""
        toks, idx = built
        pat = toks[100:125]
        got = []
        for pkg in PKGS:
            server = _server(pkg, idx[pkg.name])
            assert server._bucket_len(len(pat)) == 32
            got.append(int(server.count([pat])[0]))
        assert got == [count_naive(toks, pat)] * 2

    def test_flush_clears_queue_and_records_completed(self, built):
        toks, idx = built
        got = []
        for pkg in PKGS:
            server = _server(pkg, idx[pkg.name])
            t = server.submit(toks[10:14])
            res = server.flush()
            assert server.flush() == {}
            assert server.completed[t].count == res[t].count
            got.append(res[t].count)
        assert got[0] == got[1]


class TestFrontend:
    def test_mixed_results_match_direct(self, built):
        toks, idx = built
        reqs = requests(8, toks, 40)
        got, metrics = {}, {}
        for pkg in PKGS:
            with pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=256,
                                           max_wait_ms=1.0) as fe:
                futs = [fe.submit(p, kd, k=4 if kd == "locate" else None)
                        for p, kd in reqs]
                got[pkg.name] = [outcome(f) for f in futs]
            metrics[pkg.name] = fe.metrics()
        assert got["torch"] == got["jax"]
        assert_direct(got["torch"], direct(toks, reqs))
        same_metrics(metrics["jax"], metrics["torch"],
                     ("admitted", "rejected", "completed"))

    def test_queue_full_rejection(self, built):
        """Submits beyond max_queue shed at once; the admitted ones resolve
        when stop() drains inline (the worker never started)."""
        toks, idx = built
        got, metrics = {}, {}
        for pkg in PKGS:
            fe = pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=3, autostart=False)
            futs = [fe.submit(toks[:4]) for _ in range(4)]
            assert outcome(futs[3]) == ("Rejected", "count", "queue_full")
            assert fe.rejected == 1 and fe.admitted == 3
            fe.stop()
            got[pkg.name] = [outcome(f) for f in futs]
            metrics[pkg.name] = m = fe.metrics()
            assert m["shed_frac"] == pytest.approx(0.25)
            assert m["compact_fallbacks"] == 0
            assert m["compact_last_fallback_reason"] is None
            assert m["compact_strategy_counts"] == {}
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == ("answer", "count",
                                   count_naive(toks, toks[:4]), None)
        same_metrics(metrics["jax"], metrics["torch"])
        assert metrics["torch"]["flushes"] == metrics["jax"]["flushes"] == 1

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_burst_sheds_without_crashing(self, built, pkg):
        """Open-loop burst far above capacity: some requests shed, every
        admitted one answers as the oracle does, nothing deadlocks (which
        ones shed is timing, so each package is held to the oracle)."""
        toks, idx = built
        reqs = requests(9, toks, 200, locate_frac=0.0)
        with pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                       max_queue=8, max_wait_ms=0.5) as fe:
            futs = [fe.submit(p) for p, _ in reqs]
            got = [outcome(f) for f in futs]
        shed = sum(g[0] == "Rejected" for g in got)
        assert shed > 0, "burst into a depth-8 queue should shed"
        assert_direct(got, direct(toks, reqs))
        m = fe.metrics()
        assert m["rejected"] == shed
        assert m["admitted"] == 200 - shed == m["completed"]

    def test_metrics_buckets_have_percentiles(self, built):
        toks, idx = built
        slo = {"count": 1e9, "locate": 1e9}
        got, metrics = {}, {}
        for pkg in PKGS:
            with pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=64, slo_p99_ms=slo) as fe:
                futs = [fe.submit(toks[i: i + 3]) for i in range(10)]
                futs += [fe.submit(toks[i: i + 6], "locate")
                         for i in range(5)]
                got[pkg.name] = [outcome(f) for f in futs]
                metrics[pkg.name] = m = fe.metrics()
            assert set(m["buckets"]) == {"count/4", "locate/8"}
            b = m["buckets"]["count/4"]
            assert b["completed"] == 10
            assert 0 < b["p50_ms"] <= b["p99_ms"]
            assert b["slo_ok"] is True and b["violations"] == 0
        assert got["torch"] == got["jax"]
        same_metrics(metrics["jax"], metrics["torch"])

    def test_slo_violations_counted(self, built):
        toks, idx = built
        got = []
        for pkg in PKGS:
            with pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=64,
                                           slo_p99_ms={"count": 1e-6}) as fe:
                out = outcome(fe.submit(toks[:4]))
                m = fe.metrics()
            b = m["buckets"]["count/4"]
            assert b["violations"] == 1 and b["slo_ok"] is False
            got.append(out)
        assert got[0] == got[1]

    def test_worker_survives_dispatch_failure(self, built):
        """A request the server cannot answer (locate with k = -1 raises
        before any launch) resolves its future to the exception; the
        worker stays alive and keeps serving.  The port alone: the JAX
        package's behaviour for a negative k depends on its version."""
        toks, idx = built
        with TORCH.fe.AsyncQueryFrontend(_server(TORCH, idx["torch"]),
                                         max_queue=16) as fe:
            bad = fe.submit(toks[:4], "locate", k=-1)
            with pytest.raises(Exception):
                bad.result(timeout=WAIT)
            ok = fe.submit(toks[10:14])
            assert ok.result(timeout=WAIT).count == count_naive(
                toks, toks[10:14])
            assert fe.metrics()["worker_restarts"] == 0

    def test_cancelled_future_does_not_wedge_worker(self, built):
        toks, idx = built
        got = {}
        for pkg in PKGS:
            fe = pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=16, autostart=False)
            doomed = fe.submit(toks[:4])
            survivor = fe.submit(toks[10:14])
            assert doomed.cancel()
            fe.start()
            out = [outcome(survivor)]
            with fe:
                out.append(outcome(fe.submit(toks[:4])))
            assert doomed.cancelled()
            got[pkg.name] = out
        assert got["torch"] == got["jax"]
        assert got["torch"][0][2] == count_naive(toks, toks[10:14])

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_submit_after_stop_raises(self, built, pkg):
        toks, idx = built
        fe = pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                       max_queue=4)
        fe.stop()
        with pytest.raises(RuntimeError):
            fe.submit(toks[:4])

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_coalescing_batches_concurrent_producers(self, built, pkg):
        """Many producer threads, one flush worker: far fewer flushes than
        requests, every result the oracle's."""
        toks, idx = built
        with pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                       max_queue=1024,
                                       max_wait_ms=20.0) as fe:
            futs, lock = [], threading.Lock()

            def produce():
                for _ in range(25):
                    f = fe.submit(toks[20:24])
                    with lock:
                        futs.append(f)
                    time.sleep(0.001)

            threads = [threading.Thread(target=produce) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
                assert not t.is_alive()
            want = count_naive(toks, toks[20:24])
            assert all(f.result(timeout=WAIT).count == want for f in futs)
            m = fe.metrics()
        assert m["flushes"] < m["completed"] == 100


class TestFrontendFaults:
    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_worker_crash_restarts_and_fails_only_inflight(self, built, pkg):
        """An injected ``worker.flush`` crash kills the worker thread; the
        watchdog fails that flush's futures (a prefix of the submissions)
        with the crash, respawns a worker, and the rest answer as the
        oracle does."""
        toks, idx = built
        reqs = requests(10, toks, 30, locate_frac=0.0)
        want = direct(toks, reqs)
        with pkg.fi.inject(pkg.fi.FaultSchedule([("worker.flush", 0)])):
            with pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=256,
                                           max_wait_ms=5.0) as fe:
                futs = [fe.submit(p) for p, _ in reqs]
                got = [outcome(f) for f in futs]
                m = fe.metrics()
        crashed = [i for i, g in enumerate(got) if g[0] == "raised"]
        assert crashed == list(range(len(crashed))) and crashed
        assert all(got[i] == ("raised", "InjectedFault") for i in crashed)
        assert got[len(crashed):] == want[len(crashed):]
        assert m["worker_restarts"] == 1
        assert m["completed"] == 30 - len(crashed)

    def test_deadline_exceeded_resolves_instead_of_waiting(self, built):
        toks, idx = built
        got, metrics = {}, {}
        for pkg in PKGS:
            fe = pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=16, autostart=False)
            doomed = fe.submit(toks[:4], deadline_ms=0.0)
            alive = fe.submit(toks[:4], deadline_ms=60_000.0)
            time.sleep(0.005)
            fe.start()
            got[pkg.name] = [outcome(doomed), outcome(alive)]
            fe.stop()
            metrics[pkg.name] = fe.metrics()
        assert got["torch"] == got["jax"] == [
            ("DeadlineExceeded", "count", "deadline"),
            ("answer", "count", count_naive(toks, toks[:4]), None)]
        same_metrics(metrics["jax"], metrics["torch"])
        assert metrics["torch"]["deadline_exceeded"] == 1

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_negative_deadline_rejected_at_submit(self, built, pkg):
        toks, idx = built
        fe = pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                       max_queue=4, autostart=False)
        with pytest.raises(ValueError, match="deadline_ms"):
            fe.submit(toks[:4], deadline_ms=-1.0)
        fe.stop()

    def _pairwise_catalog(self, pkg, rng_seed):
        rng = np.random.default_rng(rng_seed)
        seg = pkg.seg(SIGMA, sample_rate=16, sa_sample_rate=8,
                      segment_min_tokens=1 << 10,
                      compact_strategy="pairwise")
        first = rng.integers(1, SIGMA, 300).astype(np.int32)
        seg.append(first)
        return seg, first, rng

    def test_transient_compaction_fault_retried(self):
        """One injected merge crash during the growth op's compaction: the
        capped-backoff retry succeeds, nothing quarantines."""
        infos, metrics = {}, {}
        for pkg in PKGS:
            seg, _, rng = self._pairwise_catalog(pkg, 23)
            new = rng.integers(1, SIGMA, 120).astype(np.int32)
            with pkg.fi.inject(pkg.fi.FaultSchedule([("merge.mid", 0)])):
                with pkg.fe.AsyncQueryFrontend(_server(pkg, seg),
                                               max_queue=16,
                                               growth_backoff_ms=1.0) as fe:
                    infos[pkg.name] = fe.append(new).result(timeout=WAIT)
                    metrics[pkg.name] = fe.metrics()
        assert infos["torch"] == infos["jax"]
        assert infos["torch"]["merges"] == 1
        assert not infos["torch"]["compaction_quarantined"]
        same_metrics(metrics["jax"], metrics["torch"],
                     COUNTERS + ("retries", "degraded",
                                 "compact_strategy_counts"))
        assert metrics["torch"]["retries"] == 1

    def test_poison_compaction_quarantined_pre_compact_serves(self):
        """A compaction that fails every retry is quarantined: the append
        lands, the pre-compact segments keep serving exactly, later
        appends skip compaction until resume_compaction()."""
        got = {}
        for pkg in PKGS:
            seg, first, rng = self._pairwise_catalog(pkg, 24)
            new = rng.integers(1, SIGMA, 120).astype(np.int32)
            poison = pkg.fi.FaultSchedule([("merge.mid", k)
                                           for k in range(4)])
            out = []
            with pkg.fi.inject(poison):
                with pkg.fe.AsyncQueryFrontend(_server(pkg, seg),
                                               max_queue=16,
                                               growth_backoff_ms=1.0) as fe:
                    info = fe.append(new).result(timeout=WAIT)
                    assert info["compaction_quarantined"]
                    assert "compaction_error" in info
                    out.append({k: v for k, v in info.items()
                                if k != "compaction_error"})
                    out.append(outcome(fe.submit(first[5:11])))
                    out.append(outcome(fe.submit(new[50:56])))
                    out.append(fe.append(rng.integers(
                        1, SIGMA, 50).astype(np.int32)).result(timeout=WAIT))
                    m = fe.metrics()
                    out.append({k: m[k] for k in COUNTERS + (
                        "retries", "degraded")})
                    fe.resume_compaction()
                    out.append(fe.append(rng.integers(
                        1, SIGMA, 50).astype(np.int32)).result(timeout=WAIT))
                    out.append(fe.metrics()["degraded"])
            assert len(seg.segments) == 1
            got[pkg.name] = out
        assert got["torch"] == got["jax"]
        t = got["torch"]
        assert t[0]["merges"] == 0 and t[3]["merges"] == 0
        assert t[4]["quarantined_segments"] == 1 and t[4]["retries"] == 3
        assert t[5]["merges"] == 1 and t[5]["segments"] == 1
        assert t[6] is False

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_submit_then_immediate_close_resolves_everything(self, built,
                                                             pkg):
        toks, idx = built
        want = count_naive(toks, toks[20:24])
        for trial in range(5):
            fe = pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=256, max_wait_ms=50.0)
            futs = [fe.submit(toks[20:24]) for _ in range(8)]
            fe.close()
            for f in futs:
                assert f.result(timeout=30).count == want, trial
            with pytest.raises(RuntimeError):
                fe.submit(toks[:4])

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_close_after_worker_crash_still_resolves(self, built, pkg):
        toks, idx = built
        with pkg.fi.inject(pkg.fi.FaultSchedule([("worker.flush", 0)])):
            fe = pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                           max_queue=64, max_wait_ms=200.0)
            futs = [fe.submit(toks[20:24]) for _ in range(6)]
            fe.close()
            got = [outcome(f) for f in futs]
        assert all(g[0] in ("raised", "answer", "Shutdown") for g in got)
        assert fe.metrics()["worker_restarts"] <= 1


class TestSegmentParallelParity:
    """The stacked fan-out served through the frontend, in both packages,
    equal to each other and to the sequential path."""

    @pytest.fixture(scope="class")
    def seg_built(self):
        rng = np.random.default_rng(11)
        chunks = [rng.integers(1, SIGMA, n).astype(np.int32)
                  for n in (350, 120, 60, 500, 90)]
        cats = {}
        for pkg in PKGS:
            cats[pkg.name] = seg = pkg.seg(SIGMA, sample_rate=16,
                                           sa_sample_rate=8)
            for c in chunks:
                seg.append(c)
        full = np.concatenate(chunks)
        pats = np.full((20, 6), PAD, np.int32)
        for b in range(20):
            L = int(rng.integers(1, 7))
            st = int(rng.integers(0, len(full) - L))
            pats[b, :L] = full[st: st + L]
        return cats, pats

    @staticmethod
    def _both(seg, fn):
        seg.parallel, seg._stacked_cache = True, None
        par = fn()
        assert seg._stacked_cache not in (None, False), "stacked path unused"
        seg.parallel, seg._stacked_cache = False, None
        sequ = fn()
        seg.parallel = None
        return par, sequ

    def test_count_parity(self, seg_built):
        cats, pats = seg_built
        par, sequ = self._both(cats["torch"],
                               lambda: cats["torch"].count(pats))
        assert np.array_equal(par.numpy(), sequ.numpy())
        assert np.array_equal(par.numpy(), cats["jax"].count(pats))

    def test_locate_parity(self, seg_built):
        cats, pats = seg_built
        (pp, pc), (sp, sc) = self._both(
            cats["torch"], lambda: cats["torch"].locate(pats, 4))
        assert np.array_equal(pp, sp) and np.array_equal(pc, sc)
        jp, jc = cats["jax"].locate(pats, 4)
        assert np.array_equal(pp.numpy(), jp)
        assert np.array_equal(pc.numpy(), jc)

    def test_parity_across_compact_boundary(self, seg_built):
        cats, pats = seg_built
        before = cats["torch"].count(pats)
        for seg in cats.values():
            assert seg.compact(min_tokens=200) >= 1
        par, sequ = self._both(cats["torch"],
                               lambda: cats["torch"].count(pats))
        assert np.array_equal(par, sequ)
        assert (par >= before).all()
        assert np.array_equal(par.numpy(), cats["jax"].count(pats))
        (pp, pc), (sp, sc) = self._both(
            cats["torch"], lambda: cats["torch"].locate(pats, 4))
        assert np.array_equal(pp, sp) and np.array_equal(pc, sc)
        jp, jc = cats["jax"].locate(pats, 4)
        assert np.array_equal(pp.numpy(), jp)

    def test_served_identically_through_frontend(self, seg_built):
        cats, pats = seg_built
        got = {}
        for pkg in PKGS:
            seg = cats[pkg.name]
            seg.parallel = True
            with pkg.fe.AsyncQueryFrontend(_server(pkg, seg),
                                           max_queue=64) as fe:
                futs = [fe.submit(pats[b][pats[b] != PAD])
                        for b in range(20)]
                got[pkg.name] = [outcome(f) for f in futs]
            seg.parallel = None
        assert got["torch"] == got["jax"]
        assert [g[2] for g in got["torch"]] == \
            cats["torch"].count(pats).tolist()

    def test_single_segment_auto_stays_sequential(self):
        seg = TORCH.seg(SIGMA, sample_rate=16, sa_sample_rate=8)
        seg.append(np.ones(50, np.int32))
        assert seg._stacked() is None
        seg.parallel = True
        assert seg._stacked() is not None


class TestFrontendAppend:
    def _segmented(self, pkg, seed, n=600):
        rng = np.random.default_rng(seed)
        seg = pkg.seg(SIGMA, sample_rate=16, sa_sample_rate=8,
                      segment_min_tokens=1 << 10, compact_trigger_ratio=0.5)
        seg.append(rng.integers(1, SIGMA, n).astype(np.int32))
        return seg, rng

    def test_append_grows_index_and_compacts(self):
        got, metrics = {}, {}
        for pkg in PKGS:
            seg, rng = self._segmented(pkg, 17)
            old = seg.segments[0].tokens
            new = rng.integers(1, SIGMA, 200).astype(np.int32)
            with pkg.fe.AsyncQueryFrontend(_server(pkg, seg),
                                           max_queue=64) as fe:
                out = [outcome(fe.submit(old[5:10]))]
                out.append(fe.append(new).result(timeout=WAIT))
                out.append(outcome(fe.submit(old[5:10])))
                out.append(outcome(fe.submit(new[50:55])))
                out.append(outcome(fe.submit(new[50:58], "locate")))
                metrics[pkg.name] = fe.metrics()
            got[pkg.name] = out
            want = count_naive(old, new[50:55]) + count_naive(new, new[50:55])
            assert out[3][2] == want >= 1
            assert out[0] == out[2]          # compaction is invariant
        assert got["torch"] == got["jax"]
        info = got["torch"][1]
        assert info["appended"] == 200 and info["merges"] == 1
        assert info["segments"] == 1 and info["total_tokens"] == 800
        same_metrics(metrics["jax"], metrics["torch"],
                     COUNTERS + ("compact_strategy_counts",))

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_append_rejected_for_monolithic_index(self, built, pkg):
        toks, idx = built
        with pkg.fe.AsyncQueryFrontend(_server(pkg, idx[pkg.name]),
                                       max_queue=8) as fe:
            with pytest.raises(TypeError, match="append"):
                fe.append(toks[:16])

    def test_append_error_resolves_future_and_worker_survives(self):
        got = {}
        for pkg in PKGS:
            seg, _ = self._segmented(pkg, 18)
            with pkg.fe.AsyncQueryFrontend(_server(pkg, seg),
                                           max_queue=8) as fe:
                bad = fe.append(np.array([99], np.int32))  # out of alphabet
                with pytest.raises(ValueError):
                    bad.result(timeout=WAIT)
                got[pkg.name] = outcome(fe.submit(
                    seg.segments[0].tokens[:6]))
                assert fe.metrics()["appends"] == 0
        assert got["torch"] == got["jax"] and got["torch"][2] >= 1


class TestLauncher:
    """``launch.serve --serve-async`` in both packages on one argv: the
    same requests, so the same ``total_hits``."""

    @staticmethod
    def _hits(text):
        line = [ln for ln in text.splitlines()
                if ln.startswith("async-serve:")]
        assert len(line) == 1, text
        return int(line[0].rsplit("total_hits=", 1)[1])

    def _both(self, capsys, argv, jax_argv=None, torch_argv=None):
        from repro.launch import serve as j_serve
        from repro_torch.launch import serve as t_serve

        capsys.readouterr()
        j_serve.main(argv + (jax_argv or []))
        j_out = capsys.readouterr().out
        out = t_serve.main(argv + (torch_argv or []) + ["--device", "cpu"])
        t_out = capsys.readouterr().out
        assert out["total_hits"] == self._hits(t_out) == self._hits(j_out)
        return out, j_out, t_out

    def test_single_index(self, capsys):
        out, _, t_out = self._both(capsys, [
            "--n", "2048", "--batch", "8", "--batches", "4",
            "--serve-async", "--queue-depth", "128"])
        m = out["metrics"]
        assert m["completed"] == 32 and m["rejected"] == 0
        assert m["flushes"] >= 1 and out["total_hits"] > 0
        assert '"buckets"' in t_out

    def test_restore_append_serve_async(self, tmp_path, capsys):
        """Build + save a catalog, then restore + --append + --serve-async
        in each package: the same hits, and each re-saved catalog holds
        the appended text."""
        from repro.launch import serve as j_serve
        from repro_torch.launch import serve as t_serve

        extra_path = str(tmp_path / "extra.npy")
        np.save(extra_path,
                np.random.default_rng(3).integers(1, 5, 512).astype(np.int32))
        j_ckpt, t_ckpt = str(tmp_path / "jcat"), str(tmp_path / "tcat")
        build = ["--kind", "dna", "--n", "2048", "--segments", "2",
                 "--batch", "4", "--batches", "2"]
        j_serve.main(build + ["--ckpt-dir", j_ckpt])
        t_serve.main(build + ["--ckpt-dir", t_ckpt, "--device", "cpu"])
        run = ["--restore", "--append", extra_path, "--serve-async",
               "--batch", "4", "--batches", "2", "--queue-depth", "128"]
        out, j_out, t_out = self._both(capsys, run, ["--ckpt-dir", j_ckpt],
                                       ["--ckpt-dir", t_ckpt])
        assert "async-appended 512 tokens" in t_out
        assert out["metrics"]["appends"] == 1
        assert out["n"] == 2048 + 512
        extra = np.load(extra_path)
        want = count_naive(extra, extra[100:110])
        for cat in (JSeg.load(j_ckpt), TSeg.load(t_ckpt, device="cpu")):
            assert cat.total_tokens == 2048 + 512
            got = cat.count(np.asarray(extra[100:110], np.int32)[None, :])
            assert int(got[0]) >= want >= 1

    def test_fault_schedule_without_async(self, capsys):
        """A ``worker.flush`` schedule on the synchronous path never fires:
        both packages serve, hit the failpoint zero times and report it."""
        from repro.launch import serve as j_serve
        from repro_torch.launch import serve as t_serve

        argv = ["--n", "2048", "--batch", "8", "--batches", "2",
                "--fault-schedule", "worker.flush:0"]
        try:
            j_serve.main(argv)
            j_out = capsys.readouterr().out
            out = t_serve.main(argv + ["--device", "cpu"])
            t_out = capsys.readouterr().out
        finally:
            j_fi.arm(None)
            t_fi.arm(None)
        report = "fault report: {'hits': {}, 'fired': []}"
        assert report in t_out and report in j_out
        assert f"total_hits={out['total_hits']}" in j_out

    def test_fault_schedule_crashes_the_first_async_flush(self, capsys):
        """``--serve-async --fault-schedule worker.flush:0``: the first
        flush's futures fail with the injected fault, which the launcher
        raises on reading the first request, in both packages."""
        from repro.launch import serve as j_serve
        from repro_torch.launch import serve as t_serve

        argv = ["--n", "2048", "--batch", "8", "--batches", "2",
                "--serve-async", "--fault-schedule", "worker.flush:0"]
        try:
            with pytest.raises(j_fi.InjectedFault):
                j_serve.main(argv)
            with pytest.raises(t_fi.InjectedFault):
                t_serve.main(argv + ["--device", "cpu"])
            assert t_fi.active().fired == j_fi.active().fired == [
                ("worker.flush", 0)]
        finally:
            j_fi.arm(None)
            t_fi.arm(None)

    def test_config_knobs_match_reference(self):
        from repro.configs import bwt_index as j_cfg
        from repro_torch.configs import bwt_index as t_cfg

        names = ("serve_queue_depth", "serve_max_wait_ms",
                 "serve_slo_p99_ms", "serve_slo_p99_ms_locate",
                 "serve_growth_retries", "serve_growth_backoff_ms")
        for cfg in ("CONFIG", "reduced"):
            j = getattr(j_cfg, cfg)
            t = getattr(t_cfg, cfg)
            j, t = (j() if callable(j) else j), (t() if callable(t) else t)
            for name in names:
                assert getattr(t, name) == getattr(j, name), (cfg, name)
