"""chip_smoke.py's checks and measurements of the fused unpacked query
kernel's redesign, rehearsed on the CPU: the walk-aimed patterns and their
parity run (the kernel's launches stood in for by the plain version), a
kernel that differs fails, the measurement sources
declare the signatures chip_smoke binds, the host line reads /proc, and
the english rows keep the earlier design's times.  No GPU.
"""

import numpy as np
import pytest
import torch
from torch_session_cache import load_chip_smoke

# one module per process: the functions handed to spawned ranks must be the
# ones the ranks import by the name chip_smoke
chip_smoke = load_chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation on a shared host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernel's launches and its plan, stood in for on the CPU: each
    launch is recorded by its k and returns the plain version's answers,
    and the plan's loads follow the index (16-byte where r % 4 == 0)."""
    from repro_torch.kernels import fm_query as fq

    ks = []

    def launch(fm, P, k=0):
        ks.append(k)
        return fq.fm_query_unpacked_plain(fm, P, k)

    def plan(fm, B, k):
        return fq.unpacked_plan(B, k, fm.sample_rate, 1)

    monkeypatch.setattr(fq, "fm_query_unpacked", launch)
    monkeypatch.setattr(fq, "unpacked_launch_plan", plan)
    return ks


def test_walk_indexes_run_on_the_cpu(plain_launches):
    """The raw-built english indexes (r = 64, 62 and 256, the last block
    partial) pass the walk-aimed parity at every k through the wrapper;
    the aimed cuts and the last block are walked."""
    rec = chip_smoke.walk_indexes(257, log2n=12, device="cpu")
    assert set(rec) == {"r=64", "r=62", "r=256"}
    for r, v in ((r, rec[f"r={r}"]) for r in (64, 62, 256)):
        assert v["vector_loads"] == (r % 4 == 0)
        assert v["n"] == (1 << 12) + 1 and v["n"] % r       # partial block
        assert v["ks"] == chip_smoke.WALK_KS
        assert v["kernels"] == 1
        assert v["launches"] == len(chip_smoke.WALK_KS)
        assert v["cuts_started"] == r and v["rows_in_last_block"] > 0
        assert v["max_abs_err"] == 0
    assert plain_launches == 3 * list(chip_smoke.WALK_KS)


def test_walk_checks_refuse_a_wrong_kernel(plain_launches, monkeypatch):
    """A kernel whose positions differ from the plain version's at one k
    fails the check, naming the k."""
    from repro_torch.kernels import fm_query as fq

    def wrong(fm, P, k=0):
        sp, ep, pos = fq.fm_query_unpacked_plain(fm, P, k)
        return sp, ep, pos + (k == 17)

    monkeypatch.setattr(fq, "fm_query_unpacked", wrong)
    with pytest.raises(AssertionError, match="kernel k=17 positions"):
        chip_smoke.walk_indexes(257, log2n=11, device="cpu")


def test_walk_edge_patterns_aim_at_rows_by_cut():
    """Substrings at rows of every aimed cut, the last rows, every length-1
    pattern, all-PAD and out-of-alphabet patterns; each substring occurs
    at the row it was cut for."""
    from repro_torch.core import alphabet as al
    from repro_torch.core.bwt import bwt_from_sa
    from repro_torch.core.fm_index import build_fm_index
    from repro_torch.core.suffix_array import suffix_array_fast
    from repro_torch.data.corpus import corpus

    toks = corpus("english", 1 << 11)
    s = torch.as_tensor(al.append_sentinel(toks))
    sa, _ = suffix_array_fast(s, 258)
    bwt, row = bwt_from_sa(s, sa)
    fm = build_fm_index(bwt, row, 258, 64, sa=sa, sa_sample_rate=32)
    pats = chip_smoke.walk_edge_patterns(fm, toks, sa, 3)
    lengths = [len(p) for p in pats]
    assert lengths.count(1) >= 257 and 0 in lengths
    assert {16, 48} <= set(lengths)
    assert any(len(p) == 1 and p[0] == 258 for p in pats)
    text = np.asarray(toks)
    for p in pats:
        if len(p) in (16, 48):
            hits = np.lib.stride_tricks.sliding_window_view(text, len(p))
            assert (hits == p).all(axis=1).any()


@pytest.mark.parametrize("src, argtypes", [
    ("SERIAL_SRC", "SERIAL_ARGTYPES"),
    ("WALK_STAMPS_SRC", "WALK_STAMPS_ARGTYPES")])
def test_unpacked_measurement_sources_declare_their_signatures(src,
                                                               argtypes):
    """The kernel before its redesign and the stamped walks, built beside
    the kernels: each C entry takes as many parameters as the argument
    types chip_smoke passes (a file read, no nvcc)."""
    import re

    text = getattr(chip_smoke, src).read_text()
    for entry, types_ in getattr(chip_smoke, argtypes).items():
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
        assert m and len(m.group(1).split(",")) == len(types_), entry


def test_serial_source_is_the_port_entry_before_the_redesign():
    """The serial copy takes the port's entry's arguments minus the
    plan's two (vec, grid)."""
    from repro_torch.kernels import _build

    assert len(chip_smoke.SERIAL_ARGTYPES[
        "fm_query_unpacked_serial_launch"]) == \
        len(_build.SIGNATURES["fm_query_unpacked"]) - 2


def test_host_line_reads_cpu_model_cores_and_load(tmp_path):
    (tmp_path / "cpuinfo").write_text(
        "processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
        "model\t\t: 143\nmodel name\t: Some CPU @ 2.0GHz\n"
        "cpu MHz\t\t: 2195.748\nflags\t: x\n\n"
        "processor\t: 1\nmodel name\t: Another CPU\n")
    (tmp_path / "loadavg").write_text("1.50 2.25 3.00 4/500 123\n")
    host = chip_smoke.host_line(12.5, tmp_path / "cpuinfo",
                                tmp_path / "loadavg")["host"]
    assert host["cpu"] == {"vendor": "GenuineIntel", "family": "6",
                           "model": "143", "model_name": "Some CPU @ 2.0GHz",
                           "mhz": "2195.748"}
    assert host["cores"] == chip_smoke.os.cpu_count()
    assert host["loadavg_1_5_15"] == [1.5, 2.25, 3.0]
    assert host["run_s"] == 12.5 and host["python_probe_s"] > 0
    real = chip_smoke.host_line(1.0)["host"]
    assert real["cores"] >= 1 and len(real["loadavg_1_5_15"]) == 3


def test_english_rows_keep_the_earlier_design_in_turns():
    """A locate bucket timed in turns with the kernel before the redesign
    keeps its before_ms and turns in the kernels line's english row."""
    turns = {"old_ms": [1.0, 1.1], "new_ms": [0.5, 0.6],
             "old_device_ms": [0.9, 0.95], "new_device_ms": [0.4, 0.45]}
    fq = {"name": "fm_query_unpacked", "index": "english n=8",
          "max_abs_err": 0, "buckets": [
              dict(m=8, B=1024, k=16, ms=0.5, device_ms=0.45, bound_ms=0.01,
                   plain_ms=40.0, before_ms=0.925, turns=turns),
              dict(m=8, B=1024, k=0, ms=0.2, device_ms=0.1, bound_ms=0.01,
                   plain_ms=10.0, before_ms=0.1, turns=turns)]}
    row = chip_smoke.english_rows(fq)
    assert [b["k"] for b in row["locate"]] == [16]
    assert row["locate"][0]["before_ms"] == 0.925
    assert row["locate"][0]["turns"] == turns
