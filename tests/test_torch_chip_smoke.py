"""The measurement helpers of chip_smoke.py (repo root), on fake profiler
rows: a per-call device time is a row's total over the launches the
profiler recorded for it, a row recorded too often or too rarely fails,
a profile that lost records is taken again, and no reading may be under
its bytes bound.  No GPU and no profiler run.
"""

import importlib.util
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
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
    assert len(taken) == 3
