"""The port's crash-safe catalog persistence (``repro_torch/core/journal.py``
and ``SegmentedIndex.save`` / ``load``) against the JAX package's: the same
generation commits and garbage collection, a crash at every failpoint of a
catalog save reopening as the pre- or the post-save catalog, quarantine of
corrupt segments, and catalogs that cross between the packages both ways
as the same bytes on disk.  Documents are numpy-seeded (13 to 34 tokens,
r = 8, SA stride 4); the port runs on the CPU.  Every output is an
integer, so the tolerance is exact equality.
"""

import os
import shutil

import numpy as np
import pytest

from repro.core import journal as jjournal
from repro.core.fm_index import PAD
from repro.core.segments import SegmentedIndex as JSeg
from repro_torch.core import journal
from repro_torch.core.segments import SegmentedIndex as TSeg
from repro_torch.testing import faultinject
from repro_torch.testing.faultinject import FaultSchedule, InjectedFault

SIGMA = 4
KW = dict(sample_rate=8, sa_sample_rate=4)


def docs_of(seed, sizes=(21, 13, 34)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SIGMA, n).astype(np.int32) for n in sizes]


def patterns(docs, seed=0, B=12, L=4):
    rng = np.random.default_rng(seed)
    pats = np.full((B, L), PAD, np.int32)
    for b in range(B):
        d = docs[b % len(docs)]
        m = int(rng.integers(1, L + 1))
        st = int(rng.integers(0, len(d) - m + 1))
        pats[b, :m] = d[st: st + m]
    return pats


def answers(cat, pats, k=200):
    """(counts, positions, clipped counts) as numpy, from either package."""
    out = [cat.count(pats), *cat.locate(pats, k)]
    return [o.cpu().numpy() if hasattr(o, "cpu") else np.asarray(o)
            for o in out]


def assert_same(a, b):
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def files_of(directory):
    """relpath -> bytes of every file under ``directory``."""
    out = {}
    for root, _, names in os.walk(directory):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, directory)] = open(p, "rb").read()
    return out


def tcat(docs, **kw):
    cat = TSeg(SIGMA, device="cpu", **KW, **kw)
    for d in docs:
        cat.append(d)
    return cat


def jcat(docs, **kw):
    cat = JSeg(SIGMA, **KW, **kw)
    for d in docs:
        cat.append(d)
    return cat


class TestJournal:
    def test_commit_gc_and_quarantine_match_reference(self, tmp_path):
        """The same calls on both packages' journals leave the same files
        and the same committed manifests."""
        dirs = {}
        for name, mod in (("jax", jjournal), ("torch", journal)):
            d = tmp_path / name
            d.mkdir()
            (d / "seg_000000").mkdir()
            (d / "seg_000000" / "a.bin").write_bytes(b"alpha")
            (d / "seg_000001").mkdir()
            (d / "seg_000001" / "b.bin").write_bytes(b"beta")
            j = mod.GenerationJournal(str(d))
            assert j.committed() is None
            files = {r: mod.manifest_entry(str(d), r)
                     for r in ("seg_000000/a.bin", "seg_000001/b.bin")}
            assert j.commit({"n": 1}, files)["generation"] == 0
            (d / "stray.tmp").write_bytes(b"x")
            keep = {"seg_000001/b.bin": files["seg_000001/b.bin"]}
            assert j.commit({"n": 2}, keep)["generation"] == 1
            removed = sorted(j.collect_garbage(keep))
            assert removed == ["gen_00000000.json", "seg_000000/a.bin",
                               "stray.tmp"]
            assert mod.verify_file(str(d), "seg_000001/b.bin",
                                   keep["seg_000001/b.bin"]) is None
            (d / "seg_000001" / "b.bin").write_bytes(b"BETA")
            assert "crc32" in mod.verify_file(str(d), "seg_000001/b.bin",
                                              keep["seg_000001/b.bin"])
            j.quarantine("seg_000001")
            assert j.committed()["catalog"] == {"n": 2}
            dirs[name] = files_of(d)
        assert dirs["torch"] == dirs["jax"]
        assert set(dirs["torch"]) == {"CURRENT", "gen_00000001.json",
                                      "quarantine/seg_000001/b.bin"}

    def test_torn_pointer_rolls_back(self, tmp_path):
        j = journal.GenerationJournal(str(tmp_path))
        j.commit({"n": 0}, {})
        j.commit({"n": 1}, {})
        (tmp_path / "gen_00000001.json").write_text("{torn")
        assert j.committed()["catalog"] == {"n": 0}


class TestAcrossPackages:
    @pytest.mark.parametrize("compact", [False, True])
    def test_same_bytes_on_disk(self, tmp_path, compact):
        """The same documents saved by either package: every file of the
        catalog directory the same bytes (segment artifacts, tokens,
        generation manifest, pointer, catalog.json)."""
        docs = docs_of(1)
        cats = {"jax": jcat(docs), "torch": tcat(docs)}
        for name, cat in cats.items():
            if compact:
                cat.append(docs[0])
                assert cat.compact(strategy="kway") == 1
            cat.save(str(tmp_path / name))
        a, b = files_of(tmp_path / "jax"), files_of(tmp_path / "torch")
        assert sorted(a) == sorted(b)
        for rel in a:
            assert a[rel] == b[rel], rel

    def test_jax_saved_loads_in_port_and_back(self, tmp_path):
        docs = docs_of(2)
        j = jcat(docs, segment_min_tokens=30)
        j.compact()
        j.save(str(tmp_path / "a"))
        t = TSeg.load(str(tmp_path / "a"), device="cpu")
        assert t.catalog() == j.catalog() and not t.degraded
        assert t._catalog_payload() == j._catalog_payload()
        pats = patterns(docs)
        assert_same(answers(t, pats), answers(j, pats))
        # the port grows it and saves; the JAX package reads it back
        t.append(docs[0])
        j.append(docs[0])
        t.save(str(tmp_path / "a"))
        back = JSeg.load(str(tmp_path / "a"))
        assert back.catalog() == j.catalog()
        assert_same(answers(back, pats), answers(j, pats))

    def test_port_saved_loads_in_jax(self, tmp_path):
        docs = docs_of(3)
        t = tcat(docs, compact_strategy="pairwise")
        t.compact(min_tokens=30)
        t.save(str(tmp_path / "b"))
        j = JSeg.load(str(tmp_path / "b"))
        assert j.catalog() == t.catalog()
        assert j.compact_strategy == "pairwise"
        assert_same(answers(j, patterns(docs)), answers(t, patterns(docs)))


@pytest.fixture(scope="module")
def crash_state(tmp_path_factory):
    """(catalog, base_dir, pre catalog): ``base_dir`` holds committed
    generation 0 (two documents); the catalog carries a third document and
    a compaction that generation 1 would commit."""
    tmp = tmp_path_factory.mktemp("crash")
    docs = docs_of(99)
    cat = tcat(docs[:2], segment_min_tokens=256)
    base = str(tmp / "base")
    cat.save(base)
    pre = TSeg.load(base, device="cpu")
    cat.append(docs[2])
    assert cat.compact(min_tokens=None) == 1
    return cat, base, pre, patterns(docs)


class TestCrashRecovery:
    def test_crash_at_every_failpoint_recovers(self, crash_state, tmp_path):
        """Every hit of every failpoint of the save, one at a time: the
        reopened catalog is the pre- or the post-save one (never a blend),
        not degraded, with no orphaned file."""
        cat, base, pre, pats = crash_state
        scratch = str(tmp_path / "scratch")
        shutil.copytree(base, scratch)
        with faultinject.inject(FaultSchedule()) as rec:
            cat.save(scratch)
        hits = dict(rec.hits)
        assert set(hits) >= {"io.write", "io.fsync", "io.rename"}, hits
        seen = set()
        for name in sorted(hits):
            for k in range(hits[name]):
                trial = str(tmp_path / f"t_{name.replace('.', '_')}_{k}")
                shutil.copytree(base, trial)
                with faultinject.inject(FaultSchedule([(name, k)])):
                    with pytest.raises(InjectedFault):
                        cat.save(trial)
                back = TSeg.load(trial, device="cpu")
                man = journal.GenerationJournal(trial).committed()
                assert not back.degraded, (name, k)
                want = pre if man["generation"] == 0 else cat
                assert back.catalog() == want.catalog(), (name, k)
                assert_same(answers(back, pats), answers(want, pats))
                seen.add(man["generation"])
                expected = set(man["files"]) | {
                    journal.CURRENT, "catalog.json",
                    journal.GEN_FMT.format(man["generation"])}
                assert set(files_of(trial)) == expected, (name, k)
        assert seen == {0, 1}

    def test_crashed_save_retries_to_a_clean_commit(self, crash_state,
                                                    tmp_path):
        cat, base, _, pats = crash_state
        trial = str(tmp_path / "retry")
        shutil.copytree(base, trial)
        with faultinject.inject(FaultSchedule([("io.rename", 0)])):
            with pytest.raises(InjectedFault):
                cat.save(trial)
        cat.save(trial)
        assert journal.GenerationJournal(trial).committed()["generation"] == 1
        back = TSeg.load(trial, device="cpu")
        assert back.catalog() == cat.catalog()
        assert_same(answers(back, pats), answers(cat, pats))

    def test_merge_crash_leaves_operands_serving(self):
        """A crash mid k-way merge leaves the operands serving; the retry
        compacts through the walk."""
        docs = docs_of(9)
        cat = tcat(docs, compact_strategy="kway")
        pats = patterns(docs)
        want = answers(cat, pats)
        ids = [s.seg_id for s in cat.segments]
        with faultinject.inject(FaultSchedule([("merge.kway", 0)])):
            with pytest.raises(InjectedFault):
                cat.compact(min_tokens=None)
        assert [s.seg_id for s in cat.segments] == ids
        assert_same(answers(cat, pats), want)
        assert cat.compact(min_tokens=None) == 1
        assert cat.compact_strategy_counts == {"kway": 1}
        assert np.array_equal(answers(cat, pats)[0], want[0])


class TestQuarantine:
    def _saved(self, tmp_path, pkg):
        docs = docs_of(31, (21, 34))
        cat = jcat(docs) if pkg == "jax" else tcat(docs)
        d = str(tmp_path / pkg)
        cat.save(d)
        return docs, d

    def test_bitrot_quarantined_like_the_reference(self, tmp_path):
        """One flipped byte in a segment's tokens: both packages withdraw
        that segment with the same reason, serve the rest, and append past
        the hole."""
        out = {}
        for pkg in ("jax", "torch"):
            docs, d = self._saved(tmp_path, pkg)
            victim = os.path.join(d, "seg_000001", "tokens.npz")
            blob = bytearray(open(victim, "rb").read())
            blob[len(blob) // 2] ^= 0xFF
            open(victim, "wb").write(bytes(blob))
            cat = (JSeg.load(d) if pkg == "jax"
                   else TSeg.load(d, device="cpu"))
            assert cat.degraded and len(cat.segments) == 1
            assert os.listdir(os.path.join(d, "quarantine"))
            seg = cat.append(docs[1][:13])
            assert seg.offset == 55
            out[pkg] = (cat.quarantined, answers(cat, patterns(docs)),
                        cat.coord_end)
        assert out["torch"][0] == out["jax"][0]
        assert "crc32" in out["torch"][0][0]["reason"]
        assert_same(out["torch"][1], out["jax"][1])
        assert out["torch"][2] == out["jax"][2] == 68

    def test_injected_checksum_fault_and_degraded_roundtrip(self, tmp_path):
        docs, d = self._saved(tmp_path, "torch")
        with faultinject.inject(FaultSchedule([("restore.checksum", 0)])):
            back = TSeg.load(d, device="cpu")
        assert back.degraded and "injected" in back.quarantined[0]["reason"]
        fresh = TSeg.load(d, device="cpu")
        assert "missing" in fresh.quarantined[0]["reason"]
        end = back.coord_end
        out = str(tmp_path / "resaved")
        back.save(out)
        again = TSeg.load(out, device="cpu")
        assert not again.degraded and again.coord_end == end

    def test_load_rejects_foreign_dir(self, tmp_path):
        (tmp_path / "catalog.json").write_text('{"format": "other"}')
        with pytest.raises(ValueError, match="catalog"):
            TSeg.load(str(tmp_path), device="cpu")
