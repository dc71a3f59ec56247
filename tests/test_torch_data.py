"""The index's data clients in the port (``repro_torch/data/dedup.py``,
``repro_torch/data/loader.py``) against the JAX package: duplicate-window
masks and contamination reports from indexes built by each package over
the same numpy-seeded corpora (the port on the CPU), and loader batches
for the same ``(seed, step)`` pairs.  Every output is a boolean, an
integer or a dict of them, so the tolerance is exact equality.
"""

import numpy as np
import pytest

from repro.data import dedup as j_dedup
from repro.data import loader as j_loader
from repro.models.transformer import LABEL_PAD as J_LABEL_PAD
from repro_torch.data import dedup as t_dedup
from repro_torch.data import loader as t_loader
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)


def both_indexes(tokens, **kw):
    return (j_dedup.build_corpus_index(tokens, **kw),
            t_dedup.build_corpus_index(tokens, device="cpu", **kw))


@pytest.fixture(scope="module")
def planted():
    """A seeded 2^14-token DNA-like corpus with two planted copies: its
    first 512 tokens again at the end, and tokens [4000, 4300) again at
    9000 (so windows straddle a copy's edges)."""
    rng = np.random.default_rng(14)
    toks = rng.integers(1, 5, 1 << 14).astype(np.int32)
    toks[9000:9300] = toks[4000:4300]
    toks = np.concatenate([toks, toks[:512]])
    return toks, both_indexes(toks, sample_rate=16)


class TestDedup:
    def test_system_case_flags_duplicates(self):
        """``test_system.py``'s dedup case: windows inside the repeated
        prefix are flagged, and the masks are equal."""
        rng = np.random.default_rng(3)
        base = rng.integers(1, 5, 200).astype(np.int32)
        dup = np.concatenate([base, base[:50]])
        ji, ti = both_indexes(dup, sample_rate=8)
        want = j_dedup.duplicate_window_mask(ji, dup, window=16, stride=16)
        got = t_dedup.duplicate_window_mask(ti, dup, window=16, stride=16)
        assert got.dtype == bool and np.array_equal(got, want)
        assert got[:32].all()

    @pytest.mark.parametrize("window,stride,threshold,batch", [
        (32, 32, 2, 256), (32, 32, 2, 4096), (16, 8, 2, 100),
        (24, None, 2, 7), (8, 3, 3, 256), (40, 50, 2, 64)])
    def test_planted_corpus_masks(self, planted, window, stride, threshold,
                                  batch):
        toks, (ji, ti) = planted
        want = j_dedup.duplicate_window_mask(ji, toks, window, stride,
                                             threshold, batch)
        got = t_dedup.duplicate_window_mask(ti, toks, window, stride,
                                            threshold, batch)
        assert np.array_equal(got, want)

    def test_planted_copies_flagged(self, planted):
        toks, (_, ti) = planted
        mask = t_dedup.duplicate_window_mask(ti, toks, 32, 32)
        n = len(toks)
        for lo, hi in ((0, 512), (n - 512, n), (4000, 4300), (9000, 9300)):
            starts = [s for s in range(0, n - 32, 32)
                      if s >= lo and s + 32 <= hi]
            assert starts and all(mask[s] for s in starts), (lo, hi)

    def test_mask_of_a_corpus_shorter_than_a_window(self):
        toks = np.array([1, 2, 3, 1, 2], np.int32)
        ji, ti = both_indexes(toks, sample_rate=8)
        for w in (5, 8):
            assert np.array_equal(
                t_dedup.duplicate_window_mask(ti, toks, w),
                j_dedup.duplicate_window_mask(ji, toks, w))


class TestContamination:
    def test_system_case_detects_leak(self):
        """``test_system.py``'s contamination case: the leaked sequence is
        reported, the one shifted out of the alphabet (+10) is not."""
        rng = np.random.default_rng(4)
        corpus = rng.integers(1, 5, 300).astype(np.int32)
        leaked = corpus[100:140].copy()
        clean = rng.integers(1, 5, 40).astype(np.int32) + 10
        ji, ti = both_indexes(corpus, sample_rate=8)
        want = j_dedup.contamination_report(ji, [leaked, clean], 16)
        got = t_dedup.contamination_report(ti, [leaked, clean], 16)
        assert got == want
        assert 0 in got["contaminated"] and 1 not in got["contaminated"]

    @pytest.mark.parametrize("probe_len", [8, 32, 100])
    def test_planted_corpus_reports(self, planted, probe_len):
        """Sequences cut from the corpus, random ones, ones out of the
        alphabet (+10, +1, a symbol 0 inside), and sequences shorter than
        a probe."""
        toks, (ji, ti) = planted
        rng = np.random.default_rng(probe_len)
        evals = []
        for i in range(24):
            L = int(rng.integers(5, 300))
            st = int(rng.integers(0, len(toks) - L))
            seq = toks[st: st + L].copy()
            if i % 4 == 1:
                seq = rng.integers(1, 5, L).astype(np.int32)
            elif i % 4 == 2:
                seq = seq + (10 if i % 8 == 2 else 1)
            elif i % 4 == 3:
                seq[L // 2] = 0
            evals.append(seq)
        want = j_dedup.contamination_report(ji, evals, probe_len)
        got = t_dedup.contamination_report(ti, evals, probe_len)
        assert got == want
        assert got["contaminated"]


class TestLoader:
    PAIRS = [(0, 0), (0, 1), (0, 17), (5, 17), (5, 1000), (7, 3),
             (123, 99), (2**31 - 1, 2**20)]

    @pytest.fixture(scope="class")
    def corpus(self):
        toks = np.random.default_rng(12).integers(1, 97, 5000).astype(
            np.int32)
        drop = np.zeros(len(toks), bool)
        drop[::3] = True
        drop[1000:3000] = True
        return toks, drop

    @pytest.mark.parametrize("seed,step", PAIRS)
    @pytest.mark.parametrize("masked", [False, True])
    def test_batches_bit_identical(self, corpus, seed, step, masked):
        toks, drop = corpus
        cfg = dict(batch_size=6, seq_len=33, seed=seed)
        j = j_loader.TokenLoader(toks, j_loader.LoaderConfig(**cfg),
                                 drop if masked else None)
        t = t_loader.TokenLoader(toks, t_loader.LoaderConfig(**cfg),
                                 drop if masked else None)
        want, got = j.batch(step), t.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for key in got:
            assert isinstance(got[key], np.ndarray)
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])

    def test_batches_iterates_steps(self, corpus):
        toks, _ = corpus
        cfg = dict(batch_size=2, seq_len=8, seed=4)
        jl = j_loader.TokenLoader(toks, j_loader.LoaderConfig(**cfg))
        tl = t_loader.TokenLoader(toks, t_loader.LoaderConfig(**cfg))
        got = list(tl.batches(3, 4))
        want = list(jl.batches(3, 4))
        assert [s for s, _ in got] == [s for s, _ in want] == [3, 4, 5, 6]
        for (_, g), (_, w) in zip(got, want):
            assert np.array_equal(g["tokens"], w["tokens"])

    def test_pad_labels(self):
        assert t_loader.LABEL_PAD == J_LABEL_PAD == -1
        labels = np.arange(24, dtype=np.int32).reshape(4, 6)
        lengths = np.array([0, 3, 6, 9])
        got = t_loader.pad_labels(labels, lengths)
        assert np.array_equal(got, j_loader.pad_labels(labels, lengths))
        assert np.array_equal(labels, np.arange(24).reshape(4, 6))
        assert (got[0] == -1).all() and (got[1, 3:] == -1).all()
        assert np.array_equal(got[2:], labels[2:])
