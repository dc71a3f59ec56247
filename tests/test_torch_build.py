"""The port's build path (keypack, both suffix-array builders, both local
sort engines, BWT, BuildStats) against the JAX package on the same seeded
inputs, at sigma {2, 4, 16, 17} plus the dna / proteins / english corpora,
n <= 2^14.

Every output is an integer (or a float computed by the same expression on
the same integers), so the tolerance is exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import alphabet as jal
from repro.core import keypack as jkp
from repro.core.bwt import bwt_from_sa as j_bwt_from_sa
from repro.core.suffix_array import _fast_round as j_fast_round
from repro.core.suffix_array import _qgram_init as j_qgram_init
from repro.core.suffix_array import suffix_array as j_suffix_array
from repro.core.suffix_array import suffix_array_fast as j_suffix_array_fast
from repro.data.corpus import corpus as j_corpus
from repro_torch.core import alphabet as al
from repro_torch.core import keypack
from repro_torch.core.bwt import bwt_from_sa, bwt_naive, inverse_bwt
from repro_torch.core.suffix_array import (
    _cap_bucket,
    _fast_round,
    _qgram_init,
    build_isa_fast,
    isa_prefix_doubling,
    suffix_array,
    suffix_array_fast,
)
from repro_torch.data.corpus import corpus
from repro_torch.kernels import ops
from repro_torch.kernels.radix_hist import TILE
from repro_torch.kernels.radix_sort import radix_sort_blocked

CORPORA = ["sigma2", "sigma4", "sigma16", "sigma17", "dna", "proteins",
           "english"]


def _text(name: str) -> np.ndarray:
    """Sentinel-terminated text: uniform over [1, sigma) (unary for
    sigma 2, the most rounds) or a corpus, n <= 2^14."""
    if name.startswith("sigma"):
        sigma = int(name[5:])
        n = 4095
        if sigma == 2:
            toks = np.ones(n, np.int32)
        else:
            rng = np.random.default_rng(sigma)
            toks = rng.integers(1, sigma, n).astype(np.int32)
    else:
        n = {"dna": (1 << 14) - 1, "proteins": 6000, "english": 5000}[name]
        toks = corpus(name, n)
        assert np.array_equal(toks, j_corpus(name, n))   # the copy agrees
    return al.append_sentinel(toks)


@pytest.fixture(scope="module")
def jax_builds():
    """The JAX package's fast build (compare engine) per corpus, computed
    once: (sa, stats dict, bwt, row)."""
    out = {}
    for name in CORPORA:
        s = _text(name)
        sigma = jal.sigma_of(s)
        sa, stats = j_suffix_array_fast(jnp.asarray(s), sigma,
                                        local_sort="compare")
        bwt, row = j_bwt_from_sa(jnp.asarray(s), sa)
        out[name] = (np.array(sa), stats.as_dict(), np.array(bwt),
                     int(row))
    return out


class TestKeypack:
    @pytest.mark.parametrize("n", [2, 3, 1000, 40000, 65535, 100000])
    def test_pairs_match_reference(self, n):
        rng = np.random.default_rng(n)
        spec = keypack.pair_spec(n)
        assert tuple(spec) == tuple(jkp.pair_spec(n))
        assert spec.key_bits == jkp.pair_spec(n).key_bits
        assert spec.pad_words() == jkp.pair_spec(n).pad_words()
        r1 = rng.integers(0, n, 512).astype(np.int32)
        r2 = rng.integers(-1, n, 512).astype(np.int32)
        r1[:2], r2[:2] = n - 1, (-1, n - 1)
        got = keypack.pack_pairs(torch.from_numpy(r1), torch.from_numpy(r2),
                                 spec)
        want = jkp.pack_pairs(jnp.asarray(r1), jnp.asarray(r2), spec)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).view(np.int32))
        u1, u2 = keypack.unpack_pairs(got, spec)
        assert np.array_equal(u1.numpy(), r1)
        assert np.array_equal(u2.numpy(), r2)

    @pytest.mark.parametrize("sigma", [2, 4, 7, 16, 17, 23, 258])
    @pytest.mark.parametrize("words", [1, 2])
    def test_qgram_keys_match_reference(self, sigma, words):
        rng = np.random.default_rng(sigma * 10 + words)
        s = np.concatenate([rng.integers(1, sigma, 300), [0]]).astype(
            np.int32)
        s[:40] = sigma - 1                       # saturated fields
        params = keypack.qgram_params(sigma, words)
        assert params == jkp.qgram_params(sigma, words)
        q, fpw, bits = params
        assert keypack.qgram_pad(fpw, bits) == jkp.qgram_pad(fpw, bits)
        assert (keypack.qgram_rounds_skipped(q)
                == jkp.qgram_rounds_skipped(q))
        got = keypack.qgram_keys_local(torch.from_numpy(s), fpw, bits, words)
        want = jkp.qgram_keys_local(jnp.asarray(s), fpw, bits, words)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).view(np.int32))


class TestSuffixArray:
    @pytest.mark.parametrize("name", CORPORA)
    @pytest.mark.parametrize("engine", ["compare", "radix"])
    def test_fast_build_matches_reference(self, jax_builds, name, engine):
        s = _text(name)
        sigma = al.sigma_of(s)
        want_sa, want_stats, want_bwt, want_row = jax_builds[name]
        sa, stats = suffix_array_fast(torch.from_numpy(s), sigma,
                                      local_sort=engine)
        assert np.array_equal(sa.numpy(), want_sa)
        got_stats = stats.as_dict()
        assert got_stats.pop("local_sort") == engine
        want_stats = dict(want_stats)
        want_stats.pop("local_sort")
        assert got_stats == want_stats
        bwt, row = bwt_from_sa(torch.from_numpy(s), sa)
        assert np.array_equal(bwt.numpy(), want_bwt)
        assert int(row) == want_row

    @pytest.mark.parametrize("name", CORPORA)
    def test_seed_builder_matches_reference(self, name):
        """The seed builder (Init -> (Pair, Re-rank)*, through the
        char_histogram and rerank_scan entries) == the JAX seed builder."""
        s = _text(name)
        sigma = al.sigma_of(s)
        sa = suffix_array(torch.from_numpy(s), sigma)
        assert np.array_equal(sa.numpy(),
                              np.asarray(j_suffix_array(jnp.asarray(s),
                                                        sigma)))

    @pytest.mark.parametrize("words", [1, 2, 3])
    def test_qgram_init_matches_reference(self, words):
        """The q-gram init's re-rank over one, two or three key words
        (runs of one symbol make keys that differ only in a later word)."""
        rng = np.random.default_rng(words)
        toks = np.ones(3000, np.int32)
        toks[rng.choice(3000, 40, replace=False)] = 2
        toks[rng.choice(3000, 10, replace=False)] = 3
        s = al.append_sentinel(toks)
        sigma = al.sigma_of(s)
        _, fpw, bits = keypack.qgram_params(sigma, words)
        rank, active = _qgram_init(torch.from_numpy(s), fpw, bits, words,
                                   "compare")
        want_rank, want_active = j_qgram_init(jnp.asarray(s), fpw, bits,
                                              words, "compare")
        assert np.array_equal(rank.numpy(), np.asarray(want_rank))
        assert np.array_equal(active.numpy(), np.asarray(want_active))

    @pytest.mark.parametrize("seed,hi", [(0, 3), (1, 3), (2, 5), (3, 2)])
    def test_fast_round_with_pads(self, seed, hi):
        """The first doubling round after a one-word q-gram init, over the
        compacted active set in its capacity bucket, so pad slots are
        present (cap > n_active): the unmasked head scans give the
        reference's ranks and next active set."""
        rng = np.random.default_rng(seed)
        n = 3000
        s = al.append_sentinel(rng.integers(1, hi, n - 1).astype(np.int32))
        sigma = al.sigma_of(s)
        q, fpw, bits = keypack.qgram_params(sigma, 1)
        rank, active = _qgram_init(torch.from_numpy(s), fpw, bits, 1,
                                   "compare")
        pos = torch.nonzero(active).flatten().to(torch.int32)
        n_active = pos.shape[0]
        cap = _cap_bucket(n_active, n)
        assert cap > n_active
        buf = torch.full((cap,), n, dtype=torch.int32)
        buf[:n_active] = pos
        # copies: jnp.asarray may alias the numpy buffer, and the
        # reference runs asynchronously while _fast_round writes rank in
        # place
        want_rank, want_active, want_still = j_fast_round(n, cap, "compare")(
            jnp.asarray(rank.numpy().copy()), jnp.asarray(buf.numpy().copy()),
            jnp.int32(n_active), jnp.int32(q))
        got_active, got_still = _fast_round(rank, buf, n_active, q, cap=cap,
                                            engine="compare")
        assert np.array_equal(rank.numpy(), np.asarray(want_rank))
        assert got_still == int(want_still)
        assert np.array_equal(got_active.numpy(), np.asarray(want_active))

    @pytest.mark.parametrize("name", ["sigma4", "english"])
    def test_block_pipeline_engine_in_build(self, jax_builds, name,
                                            monkeypatch):
        """The radix engine through the block pipeline that the CUDA
        kernels run (hist -> bases -> stable scatter, plain versions on the
        CPU) builds the reference SA."""
        monkeypatch.setattr(
            ops, "radix_sort",
            lambda operands, *, num_keys, key_bits, block=TILE:
            radix_sort_blocked(operands, num_keys, key_bits, block=block))
        s = _text(name)
        sa, _ = suffix_array_fast(torch.from_numpy(s), al.sigma_of(s),
                                  local_sort="radix")
        assert np.array_equal(sa.numpy(), jax_builds[name][0])

    def test_knob_matrix(self):
        """Every knob combination of the fast builder == the seed oracle
        (odd length, small alphabet: several rounds execute)."""
        rng = np.random.default_rng(5)
        s = al.append_sentinel(rng.integers(1, 4, 776).astype(np.int32))
        sigma = al.sigma_of(s)
        want = isa_prefix_doubling(torch.from_numpy(s), sigma)
        for engine in ("compare", "radix"):
            for qgram, qw in ((False, 1), (True, 1), (True, 2)):
                for discard in (False, True):
                    got, stats = build_isa_fast(
                        torch.from_numpy(s), sigma, local_sort=engine,
                        qgram=qgram, qgram_words=qw, discard=discard)
                    key = (engine, qgram, qw, discard)
                    assert torch.equal(got, want), key
                    assert stats.rounds_skipped == (
                        keypack.qgram_rounds_skipped(stats.q) if qgram
                        else 0)

    @pytest.mark.parametrize("builder", ["fast_1", "fast_2", "fast_3",
                                         "seed"])
    def test_rerank_calls_take_adjacent_equal_pairs(self, builder,
                                                    monkeypatch):
        """Every Re-rank call of a build (q-gram init with one, two or
        three key words, the fast rounds, the seed rounds) passes pairs in
        which equal pairs are adjacent: the CUDA kernel finds the head of a
        group that starts before its tile by probing earlier pairs, so it
        relies on that order."""
        calls = []

        def checked(r1, r2, *, block=512):
            a = r1.numpy().astype(np.int64)
            b = r2.numpy().astype(np.int64)
            runs = 1 + int(np.count_nonzero((a[1:] != a[:-1])
                                            | (b[1:] != b[:-1])))
            assert runs == len({*zip(a.tolist(), b.tolist())})
            calls.append(len(a))
            return rerank(r1, r2, block=block)

        rerank = ops.rerank_scan
        monkeypatch.setattr(ops, "rerank_scan", checked)
        rng = np.random.default_rng(9)
        toks = rng.integers(1, 4, 3000).astype(np.int32)
        toks[1000:1400] = 1             # keys equal in their first words
        s = torch.from_numpy(al.append_sentinel(toks))
        sigma = al.sigma_of(s.numpy())
        want = isa_prefix_doubling(s, sigma)
        if builder == "seed":
            got = want
        else:
            got, _ = build_isa_fast(s, sigma, qgram_words=int(builder[-1]))
        assert torch.equal(got, want)
        assert len(calls) >= 3

    def test_bwt_oracles(self):
        for sigma_hi in (4, 20):
            rng = np.random.default_rng(sigma_hi)
            s = al.append_sentinel(
                rng.integers(1, sigma_hi, 500).astype(np.int32))
            sigma = al.sigma_of(s)
            sa, _ = suffix_array_fast(torch.from_numpy(s), sigma)
            bwt, row = bwt_from_sa(torch.from_numpy(s), sa)
            want_bwt, want_row = bwt_naive(s)
            assert np.array_equal(bwt.numpy(), want_bwt)
            assert int(row) == want_row
            assert np.array_equal(inverse_bwt(bwt, row, sigma).numpy(), s)


class TestKernelLibraryLock:
    """``kernels/_build.py`` shared by threads: the serving frontend's
    worker may be the first to launch a kernel while the main thread
    builds or launches too."""

    def test_one_build_for_eight_threads(self, monkeypatch):
        import ctypes
        import threading
        import time

        from repro_torch.kernels import _build

        builds = []

        def slow_build():
            builds.append(threading.get_ident())
            time.sleep(0.05)
            return 0.05

        monkeypatch.setattr(_build, "build_all", slow_build)
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
        start = threading.Barrier(8)
        got = []

        def load():
            start.wait(timeout=30)
            got.append(_build.library("rank_packed"))

        threads = [threading.Thread(target=load) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert len(builds) == 1
        assert len(got) == 8 and all(lib is got[0] for lib in got)

    def test_temporary_outputs_name_the_thread(self, monkeypatch,
                                               tmp_path):
        """Each nvcc writes ``<library>.<pid>.<thread id>.tmp``, renamed to
        the library when it succeeds (nvcc replaced by a fake that writes
        its ``-o`` file)."""
        import os
        import threading
        import types

        from repro_torch.kernels import _build

        outs = []

        def fake_popen(cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outs.append(out)
            open(out, "w").close()
            return types.SimpleNamespace(communicate=lambda: ("", None),
                                         returncode=0)

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build.subprocess, "Popen", fake_popen)
        _build.build_all()
        tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
        assert len(outs) == len(_build.SOURCES)
        assert all(o.endswith(tag) for o in outs)
        assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
            _build._target(name).name for name in _build.SOURCES)
