"""chip_smoke.py's phase 9 (the async frontend, the launcher's
--serve-async, dedup) rehearsed on the CPU at a tiny size, a future that
raises failing it, and the dedup windows' counts by hand.  No GPU.
(Moved from ``test_torch_chip_smoke.py``, whose one worker ran them all.)
"""

import pytest
import torch
from torch_session_cache import load_chip_smoke


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
