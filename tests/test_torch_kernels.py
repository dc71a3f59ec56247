"""The port's kernel entry points (plain PyTorch versions, which CPU tensors
take) against the JAX package's Pallas kernels in interpret mode and
against both packages' ref.py oracles, on the shape sweeps of
tests/test_kernels.py.

Every output is an integer, so the tolerance is exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.radix_sort import _digit_major_bases, radix_pos_pallas
from repro.kernels.rank_select import pack_words as jpack_words
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.radix_sort import (
    digit_major_bases,
    radix_sort_blocked,
    radix_sort_plain,
)
from repro_torch.kernels.rank_select import (
    pack_words,
    packed_bits,
    rank_packed_plain,
)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def eq(got, want):
    """Exact equality of a torch result and a JAX/numpy result, compared as
    int32 bit patterns (JAX keys may be uint32)."""
    w = np.asarray(want)
    if w.dtype == np.uint32:
        w = w.view(np.int32)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == w.shape
    assert np.array_equal(g, w)


def _fused(rng, bits, sigma, nblocks, r):
    syms = rng.integers(0, sigma, nblocks * r).astype(np.int32)
    words = np.asarray(jpack_words(jnp.asarray(syms), bits)).reshape(
        nblocks, -1)
    occ = rng.integers(0, 1 << 20, (nblocks, sigma)).astype(np.int32)
    return np.concatenate([occ, words], axis=1)


class TestRankPacked:
    @pytest.mark.parametrize("bits,sigma,r", [
        (2, 4, 16), (2, 3, 32), (4, 16, 64), (4, 7, 64), (4, 5, 8),
    ])
    def test_vs_interpret_and_refs(self, bits, sigma, r):
        rng = np.random.default_rng(bits * 100 + sigma + r)
        nblocks, B = 17, 53
        fused = _fused(rng, bits, sigma, nblocks, r)
        bidx = rng.integers(0, nblocks, B).astype(np.int32)
        c = rng.integers(0, sigma, B).astype(np.int32)
        cut = rng.integers(0, r + 1, B).astype(np.int32)
        cut[:4], cut[4:8] = 0, r
        kw = dict(bits=bits, sigma=sigma)
        got = ops.rank_packed(t(fused), t(bidx), t(c), t(cut), **kw)
        jargs = [jnp.asarray(x) for x in (fused, bidx, c, cut)]
        eq(got, jops.rank_packed(*jargs, impl="interpret", **kw))
        eq(got, jref.rank_packed_ref(*jargs, **kw))
        eq(got, ref.rank_packed_ref(t(fused), t(bidx), t(c), t(cut), **kw))

    def test_pack_words_and_unpack_roundtrip(self):
        rng = np.random.default_rng(3)
        for bits in (2, 4):
            syms = rng.integers(0, 1 << bits, 64 * 5).astype(np.int32)
            syms[-7:] = -1                        # PAD tails pack as 0
            words = pack_words(t(syms), bits)
            eq(words, jpack_words(jnp.asarray(syms), bits))
            eq(ref.unpack_words(words, bits),
               jref.unpack_words(jnp.asarray(np.asarray(words)), bits))

    @pytest.mark.parametrize("sigma,r,want", [
        (4, 64, 2), (16, 64, 4), (5, 64, 4), (17, 64, 0), (4, 8, 4),
    ])
    def test_packed_bits(self, sigma, r, want):
        assert packed_bits(sigma, r) == want


class TestRankSelect:
    @pytest.mark.parametrize("nblocks,r,B", [(8, 64, 16), (32, 128, 64),
                                             (4, 256, 7)])
    @pytest.mark.parametrize("sigma", [5, 257])
    def test_vs_interpret_and_refs(self, nblocks, r, B, sigma):
        rng = np.random.default_rng(nblocks * r + B + sigma)
        bwt = rng.integers(0, sigma, (nblocks, r)).astype(np.int32)
        bidx = rng.integers(0, nblocks, B).astype(np.int32)
        c = rng.integers(0, sigma, B).astype(np.int32)
        cut = rng.integers(0, r + 1, B).astype(np.int32)
        got = ops.rank_select(t(bwt), t(bidx), t(c), t(cut))
        jargs = [jnp.asarray(x) for x in (bwt, bidx, c, cut)]
        eq(got, jops.rank_unpacked(*jargs, impl="interpret"))
        eq(got, jref.rank_select_ref(*jargs))
        eq(ops.rank_unpacked(t(bwt), t(bidx), t(c), t(cut)), got)

    def test_full_block_cutoff(self):
        bwt = np.full((2, 64), 3, np.int32)
        got = ops.rank_select(t(bwt), t(np.array([0, 1], np.int32)),
                              t(np.array([3, 3], np.int32)),
                              t(np.array([64, 0], np.int32)))
        assert got.tolist() == [64, 0]


class TestRadixHist:
    @pytest.mark.parametrize("shift", [0, 8, 16, 24])
    @pytest.mark.parametrize("n,block", [(2048, 1024), (8192, 2048),
                                         (4096, 128)])
    def test_vs_interpret_and_refs(self, shift, n, block):
        rng = np.random.default_rng(shift + n)
        keys = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        got = ops.radix_hist(t(keys), shift, block=block)
        eq(got, jops.radix_hist(jnp.asarray(keys), shift, block=block,
                                interpret=True))
        eq(got, jref.radix_hist_ref(jnp.asarray(keys), shift, block))
        eq(got, ref.radix_hist_ref(t(keys), shift, block))


class TestRadixPos:
    @pytest.mark.parametrize("shift", [0, 8, 16, 24])
    def test_vs_interpret(self, shift):
        rng = np.random.default_rng(77 + shift)
        n = 4096
        keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        keys[: n // 2] &= 0x0F0F0F0F                  # many equal digits
        hist = ops.radix_hist(t(keys.view(np.int32)), shift)
        base = digit_major_bases(hist)
        eq(base, _digit_major_bases(jnp.asarray(hist.numpy())))
        got = ops.radix_pos(t(keys.view(np.int32)), base, shift)
        eq(got, radix_pos_pallas(jnp.asarray(keys), jnp.asarray(base.numpy()),
                                 shift, interpret=True))


def _sorts(operands, num_keys, key_bits):
    """Every port sort path on the same inputs."""
    ops_t = tuple(t(np.asarray(a).view(np.int32)) for a in operands)
    return {
        "plain": radix_sort_plain(ops_t, num_keys, key_bits),
        "blocked": radix_sort_blocked(ops_t, num_keys, key_bits),
        "radix": ops.local_sort(ops_t, num_keys, engine=ops.RADIX,
                                key_bits=key_bits),
        "compare": ops.local_sort(ops_t, num_keys, engine=ops.COMPARE),
    }


class TestRadixSort:
    @pytest.mark.parametrize("n,bits", [(2048, 29), (5000, 17), (1024, 32)])
    def test_single_word(self, n, bits):
        rng = np.random.default_rng(n + bits)
        keys = rng.integers(0, 1 << min(bits, 48), n).astype(np.uint64)
        keys = (keys & ((1 << bits) - 1)).astype(np.uint32)
        pay = np.arange(n, dtype=np.int32)
        jargs = (jnp.asarray(keys), jnp.asarray(pay))
        want = jref.radix_sort_ref(jargs, 1)
        interp = jops.radix_sort(jargs, num_keys=1, key_bits=(bits,),
                                 impl="interpret")
        for got in _sorts((keys, pay), 1, (bits,)).values():
            for g, w, i in zip(got, want, interp):
                eq(g, w)
                eq(g, i)

    def test_two_word_stability(self):
        rng = np.random.default_rng(9)
        n = 3000
        hi = rng.integers(0, 7, n).astype(np.uint32)
        lo = rng.integers(0, 11, n).astype(np.uint32)
        pay = np.arange(n, dtype=np.int32)
        jargs = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pay))
        want = jref.radix_sort_ref(jargs, 2)
        interp = jops.radix_sort(jargs, num_keys=2, key_bits=(3, 4),
                                 impl="interpret")
        for got in _sorts((hi, lo, pay), 2, (3, 4)).values():
            for g, w, i in zip(got, want, interp):
                eq(g, w)
                eq(g, i)
        got = ref.radix_sort_ref(tuple(t(a.view(np.int32)) for a in
                                       (hi, lo, pay)), 2)
        for g, w in zip(got, want):
            eq(g, w)

    def test_saturated_keys_with_padding(self):
        n = 1500  # not a multiple of the kernel block
        keys = np.full(n, (1 << 12) - 1, np.uint32)
        pay = np.arange(n, dtype=np.int32)
        for got in _sorts((keys, pay), 1, (12,)).values():
            eq(got[0], keys)
            eq(got[1], pay)  # stable: untouched

    def test_full_width_keys_sort_unsigned(self):
        """Words with the top bit set (negative as int32) sort last in
        every engine, as lax.sort orders uint32."""
        rng = np.random.default_rng(11)
        keys = rng.integers(0, 1 << 32, 3000, dtype=np.uint64).astype(
            np.uint32)
        keys[::5] = 0xFFFFFFFF
        pay = np.arange(3000, dtype=np.int32)
        want = jref.radix_sort_ref((jnp.asarray(keys), jnp.asarray(pay)), 1)
        for got in _sorts((keys, pay), 1, (32,)).values():
            for g, w in zip(got, want):
                eq(g, w)


class TestOracles:
    @pytest.mark.parametrize("sigma", [6, 257])
    def test_char_histogram_ref(self, sigma):
        toks = np.random.default_rng(sigma).integers(0, sigma, 5000).astype(
            np.int32)
        eq(ref.char_histogram_ref(t(toks), sigma),
           jref.char_histogram_ref(jnp.asarray(toks), sigma))

    @pytest.mark.parametrize("vals", [3, 100000])
    def test_rerank_scan_ref(self, vals):
        rng = np.random.default_rng(vals)
        r1 = rng.integers(0, vals, 3000).astype(np.int32)
        r2 = rng.integers(-1, vals, 3000).astype(np.int32)
        order = np.lexsort((r2, r1))
        r1, r2 = r1[order], r2[order]
        got_r, got_g = ref.rerank_scan_ref(t(r1), t(r2))
        want_r, want_g = jref.rerank_scan_ref(jnp.asarray(r1), jnp.asarray(r2))
        eq(got_r, want_r)
        assert int(got_g) == int(want_g)


class TestDispatch:
    def test_cpu_tensors_never_launch(self, monkeypatch):
        """CPU tensors take the plain versions: no kernel library is ever
        loaded and no launch is counted."""
        def no_library(name):
            raise AssertionError(f"kernel library {name} requested")

        monkeypatch.setattr(_build, "library", no_library)
        before = dict(_build.LAUNCHES)
        rng = np.random.default_rng(0)
        fused = t(_fused(rng, 4, 7, 4, 64))
        q = t(np.array([0, 1, 2, 3], np.int32))
        rank_packed_plain(fused, q, q, q, bits=4, sigma=7)
        ops.rank_packed(fused, q, q, q, bits=4, sigma=7)
        ops.rank_select(t(np.zeros((4, 64), np.int32)), q, q, q)
        keys = t(rng.integers(0, 1000, 2048).astype(np.int32))
        ops.radix_hist(keys, 0)
        radix_sort_blocked((keys, keys.clone()), 1, (10,))
        ops.radix_sort((keys,), num_keys=1, key_bits=(10,))
        assert _build.LAUNCHES == before

    def test_resolve_sort_engine(self):
        assert ops.resolve_sort_engine("auto", "cpu") == ops.COMPARE
        assert ops.resolve_sort_engine("auto", "cuda") == ops.RADIX
        assert ops.resolve_sort_engine("radix", "cpu") == ops.RADIX
        with pytest.raises(ValueError):
            ops.resolve_sort_engine("bitonic", "cpu")
