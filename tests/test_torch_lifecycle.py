"""Deterministic lifecycles of ``tests/test_lifecycle_fuzz.py`` replayed in
both packages: the same seeded draws of append / compact (the drawn
strategy) / save + load / count / locate, applied to the JAX package's
``SegmentedIndex`` and to the port's (on the CPU) side by side.  At every
step both must give the document oracle's answers, the same catalog, and
the same merged indexes.  A few seeds of the reference matrix (sigma 2, 4
and 17; with and without the reserved pad slot); every output is an
integer, so the tolerance is exact equality.
"""

import numpy as np
import pytest

from repro.core.fm_index import PAD
from repro.core.segments import SegmentedIndex as JSeg
from repro_torch.core.fm_index import fm_mismatch
from repro_torch.core.segments import SegmentedIndex as TSeg
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

SAMPLE_RATE = 8
SA_SAMPLE_RATE = 4
DOC_LENS = (1, 3, 5, 8, 13, 21, 34)
STRATEGIES = ("merge", "pairwise", "kway", "rebuild")


class DocOracle:
    """Ground truth: the bag of appended documents in global coordinates
    (as in ``tests/test_lifecycle_fuzz.py``)."""

    def __init__(self):
        self.docs: list[tuple[np.ndarray, int]] = []
        self.total = 0

    def append(self, tokens):
        self.docs.append((np.asarray(tokens), self.total))
        self.total += len(tokens)

    def patterns(self, rng, B=8, L=5, sigma=4):
        pats = np.full((B, L), PAD, np.int32)
        lens = np.zeros(B, np.int64)
        for b in range(B):
            m = int(rng.integers(1, L + 1))
            lens[b] = m
            doc, _ = self.docs[int(rng.integers(len(self.docs)))]
            if rng.random() < 0.25 or len(doc) < m:
                pats[b, :m] = rng.integers(1, sigma, m)
            else:
                st = int(rng.integers(0, len(doc) - m + 1))
                pats[b, :m] = doc[st: st + m]
        return pats, lens

    def expected(self, pats, lens, k):
        B = pats.shape[0]
        counts = np.zeros(B, np.int64)
        pos = np.full((B, k), self.total, np.int64)
        kcnt = np.zeros(B, np.int64)
        for b in range(B):
            p = pats[b, : lens[b]]
            hits = []
            for doc, off in self.docs:
                if len(p) > len(doc):
                    continue
                w = np.lib.stride_tricks.sliding_window_view(doc, len(p))
                hits += (np.nonzero((w == p).all(axis=1))[0] + off).tolist()
            hits = sorted(hits)
            counts[b] = len(hits)
            kcnt[b] = min(len(hits), k)
            pos[b, : kcnt[b]] = hits[: kcnt[b]]
        return counts, pos, kcnt


def check_step(jcat, tcat, oracle, rng, sigma, ctx):
    """Both catalogs give the oracle's answers and the same catalog."""
    assert tcat.catalog() == jcat.catalog(), ctx
    assert tcat.coord_end == jcat.coord_end, ctx
    if not oracle.docs:
        return
    pats, lens = oracle.patterns(rng, sigma=sigma)
    k = 2 * oracle.total + 2
    want_c, want_p, want_k = oracle.expected(pats, lens, k)
    for name, cat in (("jax", jcat), ("torch", tcat)):
        got = [np.asarray(x.cpu() if hasattr(x, "cpu") else x)
               for x in (cat.count(pats), *cat.locate(pats, k))]
        for what, g, w in zip(("count", "positions", "located"), got,
                              (want_c, want_p, want_k)):
            assert np.array_equal(g, w), (ctx, name, what)


@pytest.mark.parametrize("sigma,reserve_pad", [(2, None), (4, None),
                                               (17, False)],
                         ids=["sigma2-reserve", "sigma4-reserve",
                              "sigma17-noreserve"])
def test_lifecycle_replays_in_both_packages(sigma, reserve_pad, tmp_path):
    rng = np.random.default_rng(1000 * sigma + (0 if reserve_pad is None
                                                else 1))
    kw = dict(sample_rate=SAMPLE_RATE, sa_sample_rate=SA_SAMPLE_RATE,
              reserve_pad=reserve_pad, segment_min_tokens=64)
    jcat, tcat = JSeg(sigma, **kw), TSeg(sigma, device="cpu", **kw)
    oracle = DocOracle()
    kinds = []
    for step in range(14):
        roll = rng.random()
        ctx = (sigma, reserve_pad, step)
        if not oracle.docs or roll < 0.45:
            m = int(rng.choice(DOC_LENS))
            toks = rng.integers(1, sigma, m).astype(np.int32)
            jcat.append(toks)
            tcat.append(toks)
            oracle.append(toks)
            kinds.append("append")
        elif roll < 0.70 and len(jcat.segments) >= 2:
            strategy = STRATEGIES[int(rng.integers(len(STRATEGIES)))]
            min_tokens = None if rng.random() < 0.5 else 40
            merged = jcat.compact(min_tokens=min_tokens, strategy=strategy)
            assert tcat.compact(min_tokens=min_tokens,
                                strategy=strategy) == merged, ctx
            assert tcat.compact_strategy_counts == \
                jcat.compact_strategy_counts, ctx
            assert tcat.compact_fallbacks == jcat.compact_fallbacks, ctx
            for js, ts in zip(jcat.segments, tcat.segments):
                assert not (d := fm_mismatch(ts.index.fm, js.index.fm)), \
                    (ctx, d)
            kinds.append(f"compact {strategy}")
        elif roll < 0.85:
            jcat.save(str(tmp_path / "jax"))
            tcat.save(str(tmp_path / "torch"))
            jcat = JSeg.load(str(tmp_path / "jax"))
            tcat = TSeg.load(str(tmp_path / "torch"), device="cpu")
            kinds.append("save+load")
        else:
            kinds.append("query")
        check_step(jcat, tcat, oracle, rng, sigma, ctx)
    if not any(k.startswith("compact") for k in kinds):
        # the schedule rolled no compaction: force one, as the fuzz does
        while len(jcat.segments) < 2:
            toks = rng.integers(1, sigma, DOC_LENS[2]).astype(np.int32)
            for cat in (jcat, tcat, oracle):
                cat.append(toks)
        assert jcat.compact(min_tokens=None) == \
            tcat.compact(min_tokens=None) == 1
        for js, ts in zip(jcat.segments, tcat.segments):
            assert not fm_mismatch(ts.index.fm, js.index.fm)
        check_step(jcat, tcat, oracle, rng, sigma, "forced")
    assert "append" in kinds and len(set(kinds)) >= 3, kinds
