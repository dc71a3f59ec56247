"""The port's segmented catalog (``repro_torch/core/segments.py``) against
the JAX package's ``SegmentedIndex``: the scenarios of
``tests/test_segments.py`` run in both packages on the same numpy-seeded
documents (segments of 20 to 700 tokens, r = 8 or 16, SA stride 4 or 8),
the port on the CPU.  Counts, located positions, catalogs, compaction
plans and every merged index must be equal: every output is an integer,
so the tolerance is exact equality.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core.fm_index import PAD
from repro.core.segments import SegmentedIndex as JSeg
from repro.serving.engine import FMQueryServer as JServer
from repro_torch.core.fm_index import StackedFMIndex, fm_mismatch
from repro_torch.core.segments import DistSAConfig
from repro_torch.core.segments import SegmentedIndex as TSeg
from repro_torch.serving.engine import FMQueryServer as TServer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIGMA = 7  # tokens 1..6
CHUNKS = (300, 150, 75, 512)
KW = dict(sample_rate=16, sa_sample_rate=8)


def pair(sigma=SIGMA, **kw):
    """The JAX catalog and the port's (on the CPU) with the same knobs."""
    return JSeg(sigma, **kw), TSeg(sigma, device="cpu", **kw)


def grow(cats, docs):
    for d in docs:
        for c in cats:
            c.append(d)


def docs_of(seed, sizes=CHUNKS, sigma=SIGMA):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, sigma, n).astype(np.int32) for n in sizes]


def patterns(seed, docs, B=24, L=5, sigma=SIGMA):
    """Substrings of the documents (some across their boundaries), random
    patterns and an all-PAD row."""
    rng = np.random.default_rng(seed)
    full = np.concatenate(docs)
    pats = np.full((B, L), PAD, np.int32)
    for b in range(B - 3):
        m = int(rng.integers(1, L + 1))
        st = int(rng.integers(0, len(full) - m))
        pats[b, :m] = full[st: st + m]
    pats[B - 3, :L] = rng.integers(1, sigma, L)
    pats[B - 2, :2] = (sigma + 2, 1)
    return pats


def assert_same_answers(jcat, tcat, pats, ks=(2, 64)):
    jc, tc = jcat.count(pats), tcat.count(pats)
    assert tc.dtype == torch.int64 and tc.device.type == "cpu"
    assert np.array_equal(tc.numpy(), jc)
    for k in ks:
        jp, jk = jcat.locate(pats, k)
        tp, tk = tcat.locate(pats, k)
        assert tp.dtype == tk.dtype == torch.int64
        assert np.array_equal(tp.numpy(), jp), k
        assert np.array_equal(tk.numpy(), jk), k


def assert_same_catalog(jcat, tcat):
    assert tcat.catalog() == jcat.catalog()
    assert tcat._catalog_payload() == jcat._catalog_payload()
    for js, ts in zip(jcat.segments, tcat.segments):
        assert not (d := fm_mismatch(ts.index.fm, js.index.fm)), d
        assert np.array_equal(ts.tokens, js.tokens)


@pytest.fixture(scope="module")
def built():
    docs = docs_of(5)
    jcat, tcat = pair(**KW)
    grow((jcat, tcat), docs)
    return docs, jcat, tcat


class TestAppend:
    def test_segments_and_catalog_match(self, built):
        docs, jcat, tcat = built
        assert_same_catalog(jcat, tcat)
        assert [c["offset"] for c in tcat.catalog()] == list(
            np.cumsum([0] + [len(d) for d in docs])[:-1])
        assert tcat.total_tokens == tcat.coord_end == sum(map(len, docs))

    def test_stacked_answers_match(self, built):
        docs, jcat, tcat = built
        pats = patterns(1, docs)
        assert_same_answers(jcat, tcat, pats)
        assert isinstance(tcat._stacked_cache, StackedFMIndex)
        assert tcat._stacked_cache.n_seg == len(docs)

    def test_sequential_path_matches(self, built):
        docs, jcat, tcat = built
        pats = patterns(2, docs)
        tcat.parallel = False
        try:
            assert_same_answers(jcat, tcat, pats)
        finally:
            tcat.parallel = None

    def test_locate_is_global_and_within_documents(self, built):
        """Global positions = the within-document occurrences (no match
        across a document boundary)."""
        docs, _, tcat = built
        pats = patterns(3, docs)
        k = 2 * sum(map(len, docs))
        pos, cnt = tcat.locate(pats, k)
        offs = np.cumsum([0] + [len(d) for d in docs])
        for b in range(pats.shape[0]):
            p = pats[b][pats[b] != PAD]     # PADs only trail here
            if not len(p):
                continue
            want = []
            for d, o in zip(docs, offs):
                w = np.lib.stride_tricks.sliding_window_view(d, len(p))
                want += (np.nonzero((w == p).all(axis=1))[0] + o).tolist()
            assert pos[b, : cnt[b]].tolist() == sorted(want), b

    def test_declared_alphabet_enforced(self):
        cat = TSeg(4, device="cpu")
        with pytest.raises(ValueError, match="alphabet"):
            cat.append(np.array([1, 2, 7], np.int32))
        with pytest.raises(ValueError, match="empty"):
            cat.append(np.array([], np.int32))
        with pytest.raises(ValueError, match="strategy"):
            TSeg(4, device="cpu", compact_strategy="other")

    def test_token_absent_from_one_segment(self):
        cats = pair(10, **KW)
        grow(cats, [np.full(50, 2, np.int32), np.full(60, 5, np.int32)])
        pats = np.full((2, 2), PAD, np.int32)
        pats[0, 0] = 5
        pats[1, :] = (2, 5)
        assert cats[1].count(pats).tolist() == [60, 0]
        assert_same_answers(*cats, pats)


class TestCompact:
    @pytest.mark.parametrize("strategy", ["merge", "kway", "pairwise",
                                          "rebuild"])
    def test_compaction_matches_reference(self, strategy):
        """The same merged segment as the JAX package under every strategy
        (equal to the rebuild), the same plan and telemetry, and answers
        unchanged by the compaction."""
        docs = docs_of(9)
        jcat, tcat = pair(**KW)
        grow((jcat, tcat), docs)
        pats = patterns(4, docs)
        before = (tcat.count(pats), *tcat.locate(pats, 1000))
        assert jcat.compact(strategy=strategy) == 1
        assert tcat.compact(strategy=strategy) == 1
        assert_same_catalog(jcat, tcat)
        assert tcat.segments[0].multi_doc
        assert tcat.compact_strategy_counts == jcat.compact_strategy_counts
        jp, tp = jcat.compact_last_plan, tcat.compact_last_plan
        for key in ("strategy", "requested", "reason", "est_walk_steps",
                    "actual_walk_steps"):
            assert tp[key] == jp[key], key
        assert tp["est"] == pytest.approx(jp["est"])
        after = (tcat.count(pats), *tcat.locate(pats, 1000))
        in_k = before[0] <= 1000     # which k of more follows SA order
        assert torch.equal(before[0], after[0])
        assert torch.equal(before[2], after[2])
        assert torch.equal(before[1][in_k], after[1][in_k])
        assert_same_answers(jcat, tcat, pats)
        oracle = TSeg(SIGMA, device="cpu", **KW)
        grow([oracle], docs)
        oracle.compact(strategy="rebuild")
        assert not fm_mismatch(tcat.segments[0].index.fm,
                               oracle.segments[0].index.fm)

    def test_threshold_preserves_large_segments(self):
        jcat, tcat = pair(**KW)
        docs = docs_of(10, (40, 30, 600, 25, 20))
        grow((jcat, tcat), docs)
        assert jcat.compact(min_tokens=100) == tcat.compact(min_tokens=100) \
            == 2
        assert [s.n_tokens for s in tcat.segments] == [70, 600, 45]
        assert_same_catalog(jcat, tcat)
        assert_same_answers(jcat, tcat, patterns(5, docs))

    def test_compact_noop_on_single_segment(self):
        cat = TSeg(SIGMA, device="cpu")
        cat.append(docs_of(11, (100,))[0])
        assert cat.compact() == 0 and len(cat.segments) == 1

    def test_maybe_compact_policy_matches(self):
        """The cost trigger with tiny merge costs, under both packages."""
        kw = dict(KW, segment_min_tokens=100, compact_cost_merge_us=0.0,
                  compact_cost_walk_ns=1.0, compact_cost_token_ns=1.0)
        cats = pair(**kw)
        got = []
        for d in docs_of(23, (400, 30, 40)):
            grow(cats, [d])
            got.append([c.maybe_compact() for c in cats])
        assert got == [[0, 0], [0, 0], [1, 1]]
        assert [len(s.docs) for s in cats[1].segments] == [1, 2]
        assert cats[1].maybe_compact() == 0
        assert_same_catalog(*cats)

    def test_maybe_compact_deferral_and_backstop_match(self):
        """Under the JAX constants equal tiny segments defer until the
        compact_max_small backstop, in both packages."""
        kw = dict(KW, segment_min_tokens=100, compact_max_small=4,
                  compact_cost_merge_us=0.0)
        cats = pair(**kw)
        got = []
        for d in docs_of(29, (30, 30, 30, 30)):
            grow(cats, [d])
            got.append([c.maybe_compact() for c in cats])
        assert got == [[0, 0]] * 3 + [[1, 1]]
        assert len(cats[1].segments) == 1
        assert len(cats[1].segments[0].docs) == 4
        assert_same_catalog(*cats)

    def test_card_constants_pick_the_rebuild(self):
        """With the port config's constants (the card's) the planner
        rebuilds a run that the JAX constants (its CPU calibration) walk
        k-way: a large left operand and two short walks; the two
        strategies build the same segment."""
        from repro_torch.configs.bwt_index import CONFIG

        docs = docs_of(31, (60000, 500, 500))
        card = TSeg.from_config(SIGMA, CONFIG.replace(sample_rate=16,
                                                      sa_sample_rate=8),
                                device="cpu")
        ref = TSeg(SIGMA, device="cpu", **KW)
        grow((card, ref), docs)
        assert card.compact() == ref.compact() == 1
        assert card.compact_last_plan["strategy"] == "rebuild"
        assert ref.compact_last_plan["strategy"] == "kway"
        assert not fm_mismatch(card.segments[0].index.fm,
                               ref.segments[0].index.fm)

    def test_unsafe_run_falls_back_with_telemetry(self):
        """Two identical merged multi-document segments: no order makes
        the run context-order safe; every merge strategy warns, counts a
        fallback and rebuilds, as in the reference."""
        d1, d2 = np.full(7, 3, np.int32), np.full(7, 1, np.int32)

        def grown(strategy):
            cats = pair(4, sample_rate=8, sa_sample_rate=4,
                        compact_strategy=strategy)
            for c in cats:
                for d in (d1, d2, d1, d2):
                    c.append(d)
                for lo in (2, 0):
                    m = c._merge_run(c.segments[lo: lo + 2], "rebuild")
                    c.segments = c.segments[:lo] + [m] + c.segments[lo + 2:]
                c._stacked_cache = None
                c.compact_strategy_counts = {}
            return cats

        for strategy in ("kway", "pairwise", "merge"):
            jcat, tcat = grown(strategy)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                jcat.compact()
            with pytest.warns(RuntimeWarning, match="fell back"):
                assert tcat.compact() == 1
            assert tcat.compact_fallbacks == jcat.compact_fallbacks == 1
            assert "context-order" in tcat.compact_last_fallback_reason
            assert tcat.compact_last_fallback_reason == \
                jcat.compact_last_fallback_reason
            assert tcat.compact_strategy_counts == {"rebuild": 1}
            assert_same_catalog(jcat, tcat)

    def test_merge_patches_the_stacked_catalog_in_place(self):
        """A compaction within the block bucket patches the stacked
        catalog; a later append writes into spare capacity without
        reallocating; stacked and sequential answers agree throughout."""
        docs = docs_of(37, (700, 40, 50, 30, 35))
        jcat, tcat = pair(parallel=True, **KW)
        grow((jcat, tcat), docs[:4])
        pats = patterns(6, docs[:1], B=8, L=4)
        want = tcat.count(pats)
        st = tcat._stacked_cache
        assert isinstance(st, StackedFMIndex)
        assert jcat.compact(min_tokens=100, strategy="merge") == \
            tcat.compact(min_tokens=100, strategy="merge") == 1
        patched = tcat._stacked_cache
        assert isinstance(patched, StackedFMIndex) and patched.n_seg == 2
        assert torch.equal(tcat.count(pats), want)
        ptrs = patched.fused.data_ptr(), patched.sa_vals.data_ptr()
        grow((jcat, tcat), docs[4:])
        grown = tcat._stacked_cache
        assert grown.n_seg == 3 and (grown.seg_pad, grown.blocks_pad) == (
            st.seg_pad, st.blocks_pad)
        assert (grown.fused.data_ptr(), grown.sa_vals.data_ptr()) == ptrs
        assert_same_answers(jcat, tcat, pats)
        tcat.parallel = False
        seq = tcat.count(pats)
        tcat.parallel = True
        assert torch.equal(seq, tcat.count(pats))


class TestMixedCatalog:
    def test_unstackable_catalog_takes_the_sequential_path(self):
        """Without the reserved pad slot segments may land on different
        alphabets: the catalog cannot stack, remembers it, and answers
        through one query per segment, as the reference's."""
        kw = dict(KW, reserve_pad=False)
        cats = pair(**kw)
        # 15 + sentinel fills a 16-token block (no pad): sigma 7; 20
        # tokens pad to 32 with pad symbol 7: sigma 8
        grow(cats, [np.full(15, 6, np.int32), docs_of(41, (20,))[0],
                    docs_of(42, (40,))[0]])
        jcat, tcat = cats
        assert len({s.index.fm.sigma for s in tcat.segments}) > 1
        pats = patterns(7, [s.tokens for s in tcat.segments])
        assert_same_answers(jcat, tcat, pats)
        assert tcat._stacked_cache is False
        strict = TSeg(SIGMA, device="cpu", parallel=True, **kw)
        grow([strict], [s.tokens for s in tcat.segments])
        with pytest.raises(ValueError, match="mixed"):
            strict.count(pats)


class TestServing:
    def test_served_through_query_server(self, built):
        """FMQueryServer serves a catalog unchanged; its answers equal the
        JAX server's over the JAX catalog."""
        docs, jcat, tcat = built
        full = np.concatenate(docs)
        queries = [full[o: o + m] for o, m in ((0, 3), (10, 4), (400, 3),
                                               (700, 5), (290, 20))]
        js = JServer(jcat, length_buckets=(4, 8), max_batch=16)
        ts = TServer(tcat, length_buckets=(4, 8), max_batch=16,
                     device="cpu")
        assert np.array_equal(ts.count(queries), js.count(queries))
        for a, b in zip(ts.locate(queries, k=8), js.locate(queries, k=8)):
            assert np.array_equal(a, b)

    def test_catalog_lives_on_its_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSeg(SIGMA)
        cat = TSeg(SIGMA, device="cpu")
        assert cat.device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TServer(cat)


class TestConfig:
    def test_from_config_matches_reference_catalog(self):
        """The port's config records the reference's sa_config (eight keys,
        its order) and knobs, so from_config catalogs are the same JSON."""
        from repro.configs.bwt_index import reduced as j_reduced
        from repro_torch.configs.bwt_index import reduced

        jcat = JSeg.from_config(SIGMA, j_reduced())
        tcat = TSeg.from_config(SIGMA, reduced(), device="cpu")
        assert tuple(tcat.sa_config._asdict()) == tuple(
            jcat.sa_config._asdict())
        assert tcat.sa_config._asdict() == jcat.sa_config._asdict()
        assert DistSAConfig()._asdict() == type(jcat.sa_config)()._asdict()
        grow((jcat, tcat), docs_of(13, (200,)))
        assert tcat._catalog_payload() == jcat._catalog_payload()
        assert tcat.count(np.array([[1]], np.int32))[0] > 0
        for name in ("segment_min_tokens", "compact_strategy",
                     "compact_max_small", "compact_trigger_cost_ratio",
                     "parallel"):
            assert getattr(tcat, name) == getattr(jcat, name), name


    def test_from_config_takes_the_engine(self):
        """The config's mesh-build engine and capacity factor (the
        reference's defaults) reach the catalog's ``sa_config`` and its
        saved JSON, as in the reference."""
        from repro.configs.bwt_index import reduced as j_reduced
        from repro_torch.configs.bwt_index import reduced

        for name in ("engine", "capacity_factor"):
            assert getattr(reduced(), name) == getattr(j_reduced(), name)
        knobs = dict(engine="bitonic", capacity_factor=4.0)
        tcat = TSeg.from_config(SIGMA, reduced().replace(**knobs),
                                device="cpu")
        jcat = JSeg.from_config(SIGMA, j_reduced().replace(**knobs))
        assert (tcat.sa_config.engine, tcat.sa_config.capacity_factor) == (
            "bitonic", 4.0)
        grow((jcat, tcat), docs_of(13, (200,)))
        assert tcat._catalog_payload() == jcat._catalog_payload()


class TestLauncher:
    def test_segments_append_save_restore(self, tmp_path, capsys):
        """``launch.serve --segments N --append PATH --ckpt-dir`` builds a
        catalog, appends (each followed by maybe_compact), saves it;
        ``--restore`` loads it back and serves."""
        from repro_torch.configs.bwt_index import CONFIG
        from repro_torch.data.corpus import corpus
        from repro_torch.launch import serve

        toks = corpus("dna", 2048)
        extra = corpus("dna", 300, seed=3)
        np.save(tmp_path / "extra.npy", extra)
        np.savez(tmp_path / "extra2.npz", tokens=extra[:100])
        ckpt = str(tmp_path / "cat")
        out = serve.main(["--n", "2048", "--segments", "3", "--batch", "8",
                          "--batches", "2", "--device", "cpu",
                          "--append", str(tmp_path / "extra.npy"),
                          "--append", str(tmp_path / "extra2.npz"),
                          "--ckpt-dir", ckpt])
        # the same growth by hand: three segments, each append followed by
        # the background policy (under the card's constants every run this
        # small compacts at once, through the rebuild)
        want = TSeg.from_config(int(toks.max()) + 1, CONFIG, device="cpu")
        for chunk in np.array_split(toks, 3):
            want.append(chunk)
        for d in (extra, extra[:100]):
            want.append(d)
            want.maybe_compact()
        loaded = TSeg.load(ckpt, device="cpu")
        assert loaded.catalog() == want.catalog()
        assert sum(len(s.docs) for s in loaded.segments) == 5
        assert out["segments"] == len(want.segments)
        assert out["n"] == 2048 + 400 and out["total_hits"] > 0
        back = serve.main(["--restore", "--ckpt-dir", ckpt, "--batch", "8",
                           "--batches", "2", "--device", "cpu"])
        assert back["segments"] == len(want.segments)
        assert back["n"] == 2448 and back["total_hits"] > 0
        text = capsys.readouterr().out
        assert "segmented catalog saved" in text
        assert f"restored segmented catalog ({len(want.segments)} " \
               f"segments, 2448 tokens" in text

    def test_restored_catalog_plans_with_config_constants(self, tmp_path,
                                                          monkeypatch):
        """``--restore --append`` plans each compaction with the config's
        cost model and fan-out (the catalog stores neither), not with the
        constructor's defaults."""
        from repro_torch.configs.bwt_index import CONFIG
        from repro_torch.core.segments import unstored_knobs
        from repro_torch.data.corpus import corpus
        from repro_torch.launch import serve

        ckpt = str(tmp_path / "cat")
        serve.main(["--n", "1024", "--segments", "2", "--batch", "4",
                    "--batches", "1", "--device", "cpu", "--ckpt-dir", ckpt])
        np.save(tmp_path / "extra.npy", corpus("dna", 200, seed=5))
        seen = []
        real = TSeg.maybe_compact

        def spy(self, *a, **kw):
            seen.append({k: getattr(self, k) for k in unstored_knobs(CONFIG)})
            return real(self, *a, **kw)

        monkeypatch.setattr(TSeg, "maybe_compact", spy)
        serve.main(["--restore", "--ckpt-dir", ckpt, "--batch", "4",
                    "--batches", "1", "--device", "cpu",
                    "--append", str(tmp_path / "extra.npy")])
        assert seen == [unstored_knobs(CONFIG)]
        # the constructor's defaults differ, so the check has teeth
        assert unstored_knobs(CONFIG) != {
            k: getattr(TSeg(4, device="cpu"), k) for k in unstored_knobs(CONFIG)}

    def test_restore_warns_of_quarantined_segments(self, tmp_path, capsys):
        """A corrupt segment is withdrawn on --restore with a WARNING; the
        healthy segments serve."""
        from repro_torch.launch import serve

        ckpt = tmp_path / "cat"
        serve.main(["--n", "1500", "--segments", "3", "--batch", "4",
                    "--batches", "1", "--device", "cpu",
                    "--ckpt-dir", str(ckpt)])
        victim = ckpt / "seg_000001" / "tokens.npz"
        blob = bytearray(victim.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        victim.write_bytes(bytes(blob))
        out = serve.main(["--restore", "--ckpt-dir", str(ckpt), "--batch",
                          "4", "--batches", "1", "--device", "cpu"])
        text = capsys.readouterr().out
        assert "WARNING: segment 1 quarantined" in text
        assert out["segments"] == 2 and out["n"] == 1000

    def test_flag_errors(self, tmp_path):
        from repro_torch.launch import serve

        with pytest.raises(SystemExit):
            serve.main(["--n", "4", "--segments", "8", "--device", "cpu"])
        np.save(tmp_path / "x.npy", np.ones(5, np.int32))
        with pytest.raises(SystemExit):   # --append needs a catalog
            serve.main(["--n", "256", "--device", "cpu", "--batches", "1",
                        "--append", str(tmp_path / "x.npy")])
        with pytest.raises(SystemExit):   # --restore needs --ckpt-dir
            serve.main(["--n", "256", "--device", "cpu", "--restore"])
        with pytest.raises(SystemExit):   # unknown flags stay rejected
            serve.main(["--n", "256", "--device", "cpu", "--serve-sync"])
