"""The port's index checkpoint/restore (``core/index_io.py``,
``training/checkpoint.py``, ``testing/faultinject.py``) against the JAX
package's: the scenarios of tests/test_index_io.py on the port, the same
on-disk artifact from both packages, checkpoints carried across packages
in both directions, the restore branch that derives the layout, and a save
crashed at every failpoint hit.

Every output is an integer, so the tolerance is exact equality.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.index_io import restore_index as j_restore_index
from repro.core.index_io import save_index as j_save_index
from repro.core.pipeline import build_index as j_build_index
from repro.testing import faultinject as j_faultinject
from repro.training.checkpoint import _flatten as j_flatten
from repro_torch.core import alphabet as al
from repro_torch.core.bwt import bwt_from_sa
from repro_torch.core.fm_index import (
    PAD,
    build_fm_index,
    count,
    fm_mismatch,
    locate,
)
from repro_torch.core.index_io import (
    CorruptCheckpointError,
    IndexIOError,
    MissingCheckpointError,
    UnsupportedVersionError,
    describe_index,
    latest_index_step,
    restore_index,
    save_index,
)
from repro_torch.core.pipeline import build_index as _build_index
from repro_torch.core.suffix_array import suffix_array
from repro_torch.data.corpus import corpus
from repro_torch.testing import faultinject
from repro_torch.training.checkpoint import Checkpointer, _flatten
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)


def build_index(toks, **kw):
    return _build_index(toks, device="cpu", **kw)


def restore(directory, **kw):
    return restore_index(str(directory), device="cpu", **kw)


def _random_patterns(rng, toks, B=8, L=6):
    pats = np.full((B, L), PAD, np.int32)
    lens = rng.integers(1, L + 1, B)
    for b in range(B):
        st = rng.integers(0, len(toks) - lens[b])
        pats[b, : lens[b]] = toks[st: st + lens[b]]
    return pats


def _answers(index, pats, k=64):
    pos, cnt = index.locate(pats, k)
    return (np.asarray(index.count(pats)), np.asarray(pos), np.asarray(cnt))


def _assert_same_index(a, b, pats, k=64):
    """count/locate parity plus field-level bit identity (either side may
    be the JAX package's index)."""
    for x, y in zip(_answers(a, pats, k), _answers(b, pats, k)):
        assert np.array_equal(x, y)
    assert fm_mismatch(a.fm, b.fm) == []


class TestRoundtrip:
    def test_bit_identical(self, tmp_path):
        rng = np.random.default_rng(0)
        toks = rng.integers(1, 5, 777).astype(np.int32)
        idx = build_index(toks, sample_rate=16, sa_sample_rate=8)
        save_index(str(tmp_path), idx)
        rest = restore(tmp_path)
        _assert_same_index(idx, rest, _random_patterns(rng, toks))
        assert rest.text_length == idx.text_length
        assert rest.length == idx.length and rest.sa is None

    def test_no_sa_sample(self, tmp_path):
        """Empty SA sample (sa_sample_rate=0): roundtrips, locate raises."""
        rng = np.random.default_rng(1)
        toks = rng.integers(1, 5, 300).astype(np.int32)
        idx = build_index(toks, sample_rate=16, sa_sample_rate=0)
        save_index(str(tmp_path), idx)
        rest = restore(tmp_path)
        pats = _random_patterns(rng, toks)
        assert torch.equal(idx.count(pats), rest.count(pats))
        assert rest.fm.sa_vals is None and rest.fm.sa_sample_rate == 0
        assert fm_mismatch(idx.fm, rest.fm) == []
        with pytest.raises(ValueError, match="locate unavailable"):
            rest.locate(pats, 4)

    @pytest.mark.parametrize("sigma,want_bits", [
        (4, 2),    # 2-bit packing
        (16, 4),   # 4-bit packing, at the boundary
        (17, 0),   # one past the boundary: unpacked layout
    ])
    def test_packing_boundary(self, tmp_path, sigma, want_bits):
        """sigma = 16 (sentinel + 15 symbols) is the last packable alphabet;
        17 takes the unpacked layout; both roundtrip bit-identically."""
        rng = np.random.default_rng(2)
        r = 16
        toks = rng.integers(1, sigma, 16 * r - 1).astype(np.int32)
        toks[: sigma - 1] = np.arange(1, sigma)  # realise the full alphabet
        s = torch.from_numpy(al.append_sentinel(toks))
        assert al.sigma_of(s.numpy()) == sigma
        sa = suffix_array(s, sigma)
        bwt_arr, row = bwt_from_sa(s, sa)
        fm = build_fm_index(bwt_arr, row, sigma, r, sa=sa, sa_sample_rate=4)
        assert fm.bits == want_bits
        save_index(str(tmp_path), fm)
        info = describe_index(str(tmp_path))
        assert info.bits == want_bits and info.kind == "fm"
        assert info.text_length == fm.length      # a bare FMIndex
        rest = restore(tmp_path)
        assert rest.fm.bits == want_bits
        assert fm_mismatch(fm, rest.fm) == []
        pats = torch.from_numpy(_random_patterns(rng, toks))
        assert torch.equal(count(fm, pats), rest.count(pats))
        pa, ca = locate(fm, pats, 32)
        pb, cb = rest.locate(pats, 32)
        assert torch.equal(pa, pb) and torch.equal(ca, cb)

    def test_uncompressed_sa_roundtrip(self, tmp_path):
        rng = np.random.default_rng(3)
        toks = rng.integers(1, 5, 500).astype(np.int32)
        idx = build_index(toks, sample_rate=16, sa_sample_rate=8,
                          compress_sa=False)
        assert idx.fm.sa_val_bits == 0
        save_index(str(tmp_path), idx)
        rest = restore(tmp_path)
        assert rest.fm.sa_val_bits == 0
        _assert_same_index(idx, rest, _random_patterns(rng, toks))

    def test_keep_k_steps(self, tmp_path):
        rng = np.random.default_rng(4)
        toks = rng.integers(1, 5, 200).astype(np.int32)
        idx = build_index(toks, sample_rate=16)
        for step in (1, 2, 3):
            save_index(str(tmp_path), idx, step=step, keep=2)
        assert latest_index_step(str(tmp_path)) == 3
        assert Checkpointer(str(tmp_path)).all_steps() == [2, 3]
        pats = _random_patterns(rng, toks)
        rest = restore(tmp_path, step=2)
        assert torch.equal(idx.count(pats), rest.count(pats))

    def test_derived_layout_branch(self, tmp_path):
        """A checkpoint without the single-device layout (the reference's
        ``dist_fm`` kind: BWT, row and SA sample only) restores through
        ``build_fm_index``, in both packages, to the index that was saved."""
        rng = np.random.default_rng(12)
        for kind, sample_rate in (("dna", 64), ("proteins", 32)):
            toks = corpus(kind, 1500)
            idx = build_index(toks, sample_rate=sample_rate,
                              sa_sample_rate=8)
            d = tmp_path / kind
            save_index(str(d), idx)
            step = d / "step_00000000"
            with np.load(str(step / "arrays.npz")) as z:
                flat = {k: z[k] for k in z.files
                        if k not in ("c_array", "occ_samples", "fused")}
            np.savez(str(step / "arrays.npz"), **flat)
            meta = json.loads((step / "meta.json").read_text())
            meta["kind"] = "dist_fm"
            meta["arrays"] = sorted(flat)
            (step / "meta.json").write_text(json.dumps(meta))
            pats = _random_patterns(rng, toks)
            _assert_same_index(idx, restore(d), pats)
            _assert_same_index(idx, j_restore_index(str(d)), pats)

    def test_mesh_not_ported(self, tmp_path):
        """Kept by name from before restoring onto a mesh was ported (its
        scenarios: ``test_torch_dist_io.py``): a mesh that is not a
        ``DeviceMesh`` with a ``"parts"`` dimension is refused with a
        ``TypeError`` before the checkpoint is read."""
        idx = build_index(np.ones(100, np.int32), sample_rate=16)
        save_index(str(tmp_path), idx)
        with pytest.raises(TypeError, match="DeviceMesh"):
            restore_index(str(tmp_path), object(), device="cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            restore_index(str(tmp_path / "missing"), object(), device="cpu")

    def test_restore_needs_gpu_unless_cpu_given(self, tmp_path, monkeypatch):
        idx = build_index(np.ones(100, np.int32), sample_rate=16)
        save_index(str(tmp_path), idx)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_index(str(tmp_path))


class TestAcrossPackages:
    """The same artifact on disk from either package, read by the other."""

    @pytest.mark.parametrize("kind,sample_rate,sa_rate", [
        ("dna", 64, 32), ("proteins", 32, 8), ("english", 16, 4)])
    def test_same_files_from_both_packages(self, tmp_path, kind,
                                           sample_rate, sa_rate):
        toks = corpus(kind, 2000)
        kw = dict(sample_rate=sample_rate, sa_sample_rate=sa_rate)
        save_index(str(tmp_path / "port"), build_index(toks, **kw), step=7)
        j_save_index(str(tmp_path / "jax"), j_build_index(toks, **kw),
                     step=7)
        port, ref = (tmp_path / side / "step_00000007"
                     for side in ("port", "jax"))
        assert (port / "meta.json").read_text() == (
            ref / "meta.json").read_text()
        with np.load(str(port / "arrays.npz")) as a, \
                np.load(str(ref / "arrays.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert np.array_equal(a[k], b[k]), k

    @pytest.mark.parametrize("toks_hi,sample_rate,compress", [
        (5, 16, None), (5, 16, False), (30, 32, None)])
    def test_jax_saved_restores_in_port(self, tmp_path, toks_hi,
                                        sample_rate, compress):
        rng = np.random.default_rng(toks_hi + sample_rate)
        toks = rng.integers(1, toks_hi, 900).astype(np.int32)
        want = j_build_index(toks, sample_rate=sample_rate, sa_sample_rate=8,
                             compress_sa=compress)
        j_save_index(str(tmp_path), want)
        got = restore(tmp_path)
        assert got.text_length == want.text_length
        _assert_same_index(got, want, _random_patterns(rng, toks))

    @pytest.mark.parametrize("toks_hi,sample_rate,compress", [
        (5, 16, None), (5, 16, False), (30, 32, None)])
    def test_port_saved_restores_in_jax(self, tmp_path, toks_hi,
                                        sample_rate, compress):
        rng = np.random.default_rng(toks_hi * sample_rate)
        toks = rng.integers(1, toks_hi, 900).astype(np.int32)
        idx = build_index(toks, sample_rate=sample_rate, sa_sample_rate=8,
                          compress_sa=compress)
        save_index(str(tmp_path), idx)
        got = j_restore_index(str(tmp_path))
        assert got.text_length == idx.text_length
        _assert_same_index(idx, got, _random_patterns(rng, toks))

    def test_flatten_keys_match_reference(self):
        tree = {"b": np.arange(3, dtype=np.int32),
                "a": {"y": [np.ones(2, np.float32), np.zeros((2, 2))],
                      "x": np.int32(5)}}
        want = j_flatten(tree)
        got = _flatten({"b": torch.arange(3, dtype=torch.int32),
                        "a": {"y": [torch.ones(2), np.zeros((2, 2))],
                              "x": np.int32(5)}})
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
        assert _flatten({"h": torch.ones(2, dtype=torch.bfloat16)})[
            "h"].dtype == np.float32


class TestManifest:
    def test_version_guard(self, tmp_path):
        rng = np.random.default_rng(5)
        idx = build_index(rng.integers(1, 5, 200).astype(np.int32),
                          sample_rate=16)
        save_index(str(tmp_path), idx)
        meta_path = tmp_path / "step_00000000" / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["version"] = 999
        meta_path.write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="newer"):
            restore(tmp_path)

    def test_not_an_index(self, tmp_path):
        Checkpointer(str(tmp_path)).save(0, {"x": torch.zeros(4)})
        with pytest.raises(ValueError, match="not an index checkpoint"):
            restore(tmp_path)

    def test_describe_empty(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            describe_index(str(tmp_path))

    def test_read_paths_do_not_create_directories(self, tmp_path):
        """Restoring/describing a mistyped path must not leave an empty
        directory tree behind (Checkpointer creates dirs lazily, on save)."""
        missing = tmp_path / "no" / "such" / "index"
        with pytest.raises(FileNotFoundError):
            restore(missing)
        with pytest.raises(FileNotFoundError):
            describe_index(str(missing))
        assert latest_index_step(str(missing)) is None
        assert not missing.exists()


class TestTypedErrors:
    """Every restore failure mode raises a typed, actionable IndexIOError
    subclass that also derives from the stdlib exception older callers
    caught (FileNotFoundError / ValueError)."""

    @pytest.fixture()
    def saved(self, tmp_path):
        rng = np.random.default_rng(9)
        toks = rng.integers(1, 5, 300).astype(np.int32)
        idx = build_index(toks, sample_rate=16, sa_sample_rate=8)
        save_index(str(tmp_path), idx)
        return tmp_path

    def test_empty_dir_is_missing(self, tmp_path):
        with pytest.raises(MissingCheckpointError) as ei:
            restore(tmp_path)
        assert isinstance(ei.value, FileNotFoundError)
        assert "save_index" in str(ei.value)  # actionable: how to make one

    def test_missing_manifest(self, saved):
        (saved / "step_00000000" / "meta.json").unlink()
        with pytest.raises(MissingCheckpointError):
            restore(saved)
        with pytest.raises(MissingCheckpointError, match="torn"):
            describe_index(str(saved))

    def test_version_from_the_future_is_typed(self, saved):
        meta_path = saved / "step_00000000" / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["version"] = 999
        meta_path.write_text(json.dumps(meta))
        with pytest.raises(UnsupportedVersionError, match="newer") as ei:
            restore(saved)
        assert isinstance(ei.value, (IndexIOError, ValueError))
        with pytest.raises(UnsupportedVersionError):
            describe_index(str(saved))

    def test_truncated_arrays_file(self, saved):
        """A torn arrays.npz (half the bytes) is corruption, not a crash
        with a zipfile traceback."""
        path = saved / "step_00000000" / "arrays.npz"
        blob = path.read_bytes()
        path.write_bytes(blob[: len(blob) // 2])
        with pytest.raises(CorruptCheckpointError, match="unreadable") as ei:
            restore(saved)
        assert isinstance(ei.value, ValueError)

    def test_missing_declared_array(self, saved):
        """arrays.npz missing a leaf the manifest declares -> corrupt, with
        the missing names listed."""
        path = saved / "step_00000000" / "arrays.npz"
        with np.load(str(path)) as z:
            flat = {k: z[k] for k in z.files if k != "row"}
        np.savez(str(path), **flat)
        with pytest.raises(CorruptCheckpointError, match="row"):
            restore(saved)

    def test_truncated_bwt_array(self, saved):
        """A bwt shorter than the manifest's length -> corrupt (truncated),
        caught before any index math runs."""
        path = saved / "step_00000000" / "arrays.npz"
        with np.load(str(path)) as z:
            flat = {k: z[k] for k in z.files}
        flat["bwt"] = flat["bwt"][: len(flat["bwt"]) // 2]
        np.savez(str(path), **flat)
        with pytest.raises(CorruptCheckpointError, match="truncated"):
            restore(saved)

    def test_unreadable_manifest_json(self, saved):
        (saved / "step_00000000" / "meta.json").write_text("{not json")
        with pytest.raises(CorruptCheckpointError):
            restore(saved)
        with pytest.raises(CorruptCheckpointError, match="unreadable"):
            describe_index(str(saved))

    def test_family_catch_all(self, saved):
        """One except clause covers the whole family."""
        (saved / "step_00000000" / "meta.json").unlink()
        with pytest.raises(IndexIOError):
            restore(saved)


def _hits_of_one_save(tmp_path, idx):
    with faultinject.inject(faultinject.FaultSchedule()) as rec:
        save_index(str(tmp_path / "probe"), idx)
    return rec.hits


class TestCrashSafety:
    def test_failpoints_and_grammar_match_reference(self, monkeypatch):
        assert faultinject.FAILPOINTS == j_faultinject.FAILPOINTS
        assert faultinject.ENV_VAR == j_faultinject.ENV_VAR
        spec = "io.write:1, io.rename:0"
        sched = faultinject.FaultSchedule.parse(spec)
        assert sched._triggers == j_faultinject.FaultSchedule.parse(
            spec)._triggers
        with pytest.raises(ValueError, match="unknown failpoint"):
            faultinject.FaultSchedule.parse("io.nope:0")
        monkeypatch.setenv(faultinject.ENV_VAR, "io.rename:0")
        try:
            armed = faultinject.arm_from_env()
            assert faultinject.active() is armed
            assert armed.should_fire("io.rename")
        finally:
            faultinject.arm(None)

    def test_save_hits_writes_and_rename(self, tmp_path):
        idx = build_index(np.ones(200, np.int32) * 2, sample_rate=16)
        assert _hits_of_one_save(tmp_path, idx) == {"io.write": 2,
                                                    "io.rename": 1}

    @pytest.mark.parametrize("point,hit", [("io.write", 0), ("io.write", 1),
                                           ("io.rename", 0)])
    def test_crashed_save_keeps_previous_step(self, tmp_path, point, hit):
        """A save crashed at any failpoint hit leaves the previous step the
        latest, restorable with its answers; the next save succeeds."""
        rng = np.random.default_rng(11)
        toks = rng.integers(1, 5, 600).astype(np.int32)
        old = build_index(toks, sample_rate=16, sa_sample_rate=8)
        new = build_index(toks[::-1].copy(), sample_rate=16, sa_sample_rate=8)
        save_index(str(tmp_path), old, step=0)
        sched = faultinject.FaultSchedule([(point, hit)])
        with faultinject.inject(sched):
            with pytest.raises(faultinject.InjectedFault):
                save_index(str(tmp_path), new, step=1)
        assert sched.fired == [(point, hit)]
        assert latest_index_step(str(tmp_path)) == 0
        pats = _random_patterns(rng, toks)
        _assert_same_index(old, restore(tmp_path), pats)
        save_index(str(tmp_path), new, step=1)
        assert latest_index_step(str(tmp_path)) == 1
        _assert_same_index(new, restore(tmp_path), pats)

    def test_save_async_then_wait(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=1)
        ck.save_async(3, {"x": torch.arange(5)}, extra={"tag": "a"})
        ck.wait()
        ck.save_async(4, {"x": torch.arange(6)})
        ck.wait()
        flat, meta = ck.restore_raw()
        assert ck.all_steps() == [4] and meta == {"step": 4}
        assert np.array_equal(flat["x"], np.arange(6))
