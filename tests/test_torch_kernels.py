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
from repro_torch.kernels.char_histogram import char_histogram_plain
from repro_torch.kernels.radix_hist import TILE, TILES
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
from repro_torch.kernels.rerank_scan import TILE as RERANK_TILE
from repro_torch.kernels.rerank_scan import rerank_scan_plain
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)


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

    @pytest.mark.parametrize("batch", ["walk", "consecutive"])
    def test_wide_batches(self, batch):
        """The batches the redesigned kernel is planned for: the mesh
        locate walk's 16,384 random queries at r = 64, and an LF map's
        walked rows in consecutive order (block row // r, cut row % r, c
        the symbol at the row), each block hit r times."""
        rng = np.random.default_rng(16384)
        nblocks, r, sigma = 300, 64, 23
        bwt = rng.integers(0, sigma, (nblocks, r)).astype(np.int32)
        if batch == "walk":
            B = 16384
            bidx = rng.integers(0, nblocks, B).astype(np.int32)
            c = rng.integers(0, sigma, B).astype(np.int32)
            cut = rng.integers(0, r + 1, B).astype(np.int32)
            cut[:8], cut[8:16] = 0, r
        else:
            rows = np.arange(nblocks * r, dtype=np.int32)
            bidx, cut = rows // r, rows % r
            c = bwt.reshape(-1)[rows]
        got = ops.rank_select(t(bwt), t(bidx), t(c), t(cut))
        jargs = [jnp.asarray(x) for x in (bwt, bidx, c, cut)]
        eq(got, jops.rank_unpacked(*jargs, impl="interpret"))
        eq(got, jref.rank_select_ref(*jargs))

    def test_full_block_cutoff(self):
        bwt = np.full((2, 64), 3, np.int32)
        got = ops.rank_select(t(bwt), t(np.array([0, 1], np.int32)),
                              t(np.array([3, 3], np.int32)),
                              t(np.array([64, 0], np.int32)))
        assert got.tolist() == [64, 0]


class TestRadixHist:
    @pytest.mark.parametrize("shift", [0, 8, 16, 24])
    @pytest.mark.parametrize("n,block", [(2048, 1024), (8192, 2048),
                                         (4096, 128), (2 * TILE, TILE),
                                         (4 * TILE, TILE)])
    def test_vs_interpret_and_refs(self, shift, n, block):
        rng = np.random.default_rng(shift + n)
        keys = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        got = ops.radix_hist(t(keys), shift, block=block)
        eq(got, jops.radix_hist(jnp.asarray(keys), shift, block=block,
                                interpret=True))
        eq(got, jref.radix_hist_ref(jnp.asarray(keys), shift, block))
        eq(got, ref.radix_hist_ref(t(keys), shift, block))


_SHIFTS = (0, 8, 16, 24)


class TestRadixPos:
    # the JAX kernels' block (ids kept as the shift alone), then the tile
    @pytest.mark.parametrize("shift,n,block", [
        *(pytest.param(s, 4096, 1024, id=str(s)) for s in _SHIFTS),
        *(pytest.param(s, n, TILE, id=f"{n}-{TILE}-{s}")
          for n in (2 * TILE, 4 * TILE) for s in _SHIFTS),
    ])
    def test_vs_interpret(self, shift, n, block):
        rng = np.random.default_rng(77 + shift)
        keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        keys[: n // 2] &= 0x0F0F0F0F                  # many equal digits
        hist = ops.radix_hist(t(keys.view(np.int32)), shift, block=block)
        eq(hist, jref.radix_hist_ref(jnp.asarray(keys), shift, block))
        base = digit_major_bases(hist)
        eq(base, _digit_major_bases(jnp.asarray(hist.numpy())))
        got = ops.radix_pos(t(keys.view(np.int32)), base, shift, block=block)
        eq(got, radix_pos_pallas(jnp.asarray(keys), jnp.asarray(base.numpy()),
                                 shift, block=block, interpret=True))
        # a stable counting pass: positions are a permutation that orders
        # the digits and keeps equal digits in input order
        d = (keys >> shift) & 0xFF
        eq(got, np.argsort(np.argsort(d, kind="stable"), kind="stable"))


def _sorts(operands, num_keys, key_bits):
    """Every port sort path on the same inputs: the tile pipeline at the
    JAX kernels' block and at the sort engine's tile."""
    ops_t = tuple(t(np.asarray(a).view(np.int32)) for a in operands)
    return {
        "plain": radix_sort_plain(ops_t, num_keys, key_bits),
        "blocked": radix_sort_blocked(ops_t, num_keys, key_bits, block=1024),
        "tiled": radix_sort_blocked(ops_t, num_keys, key_bits),
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

    @pytest.mark.parametrize("n", [TILE + 5, 2 * TILE - 1])
    def test_tile_pads_stay_last(self, n):
        """n not a multiple of the tile, and real keys equal to the
        field-limited pad: the appended pads must sort after them."""
        rng = np.random.default_rng(n)
        hi = rng.integers(0, 1 << 5, n).astype(np.uint32)
        lo = rng.integers(0, 1 << 12, n).astype(np.uint32)
        hi[::3], lo[::3] = (1 << 5) - 1, (1 << 12) - 1   # saturated keys
        pay = np.arange(n, dtype=np.int32)
        jargs = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pay))
        want = jref.radix_sort_ref(jargs, 2)
        got_t = radix_sort_blocked(
            tuple(t(a.view(np.int32)) for a in (hi, lo, pay)), 2, (5, 12),
            block=TILE)
        for got in (got_t, *_sorts((hi, lo, pay), 2, (5, 12)).values()):
            for g, w in zip(got, want):
                eq(g, w)

    @pytest.mark.parametrize("extra", [17, -1])
    @pytest.mark.parametrize("block", TILES)
    def test_block_changes_no_result(self, block, extra):
        """Both tiles the kernels take give the same sort, through the tile
        pipeline and through ``ops.radix_sort``'s ``block``; n is a few keys
        past a tile edge, or one short of one (a tile less one key of
        pads)."""
        rng = np.random.default_rng(block + extra)
        n = 3 * block + extra
        keys = t(rng.integers(0, 1 << 20, n).astype(np.int32))
        pay = t(np.arange(n, dtype=np.int32))
        want = radix_sort_plain((keys, pay), 1, (20,))
        for got in (radix_sort_blocked((keys, pay), 1, (20,), block=block),
                    ops.radix_sort((keys, pay), num_keys=1, key_bits=(20,),
                                   block=block)):
            for g, w in zip(got, want):
                assert torch.equal(g, w)

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


class TestCharHistogram:
    @pytest.mark.parametrize("n", [1024, 5000, 12345])
    @pytest.mark.parametrize("sigma", [6, 22, 257])
    def test_vs_interpret_and_refs(self, n, sigma):
        rng = np.random.default_rng(n + sigma)
        toks = rng.integers(0, sigma, n).astype(np.int32)
        got = ops.char_histogram(t(toks), sigma)
        eq(got, jops.char_histogram(jnp.asarray(toks), sigma, interpret=True))
        eq(got, jref.char_histogram_ref(jnp.asarray(toks), sigma))
        eq(got, ref.char_histogram_ref(t(toks), sigma))
        eq(char_histogram_plain(t(toks), sigma), got.numpy())

    @pytest.mark.parametrize("n", [777, 4096])
    def test_out_of_range_values_count_nowhere(self, n):
        """Negatives and values >= sigma are dropped, as the reference's
        one-hot drops its pad value sigma; n % 1024 != 0 pads there."""
        rng = np.random.default_rng(n)
        sigma = 7
        toks = rng.integers(-3, sigma + 4, n).astype(np.int32)
        toks[:5] = (-(2**31), 2**31 - 1, sigma, -1, 0)
        got = ops.char_histogram(t(toks), sigma)
        eq(got, jops.char_histogram(jnp.asarray(toks), sigma, interpret=True))
        eq(got, ref.char_histogram_ref(t(toks), sigma))
        assert int(got.sum()) == int(((toks >= 0) & (toks < sigma)).sum())

    @pytest.mark.parametrize("block_rows", [1, 4, 16])
    def test_block_rows_change_nothing(self, block_rows):
        toks = np.random.default_rng(0).integers(0, 17, 8192).astype(np.int32)
        got = ops.char_histogram(t(toks), 17, block_rows=block_rows)
        eq(got, jops.char_histogram(jnp.asarray(toks), 17,
                                    block_rows=block_rows, interpret=True))

    def test_initial_ranks_from_histogram(self):
        """Histogram + exclusive cumsum == the paper's Occ table, in both
        packages."""
        from repro.core.suffix_array import initial_ranks as j_initial_ranks
        from repro_torch.core.suffix_array import initial_ranks

        s = np.random.default_rng(10).integers(0, 6, 4096).astype(np.int32)
        eq(initial_ranks(t(s), 6), j_initial_ranks(jnp.asarray(s), 6))


def _sorted_pairs(rng, n, vals):
    r1 = rng.integers(0, vals, n).astype(np.int32)
    r2 = rng.integers(-1, vals, n).astype(np.int32)
    order = np.lexsort((r2, r1))
    return r1[order], r2[order]


class TestRerankScan:
    def _check(self, r1, r2, *, interpret=True, **kw):
        got_r, got_g = ops.rerank_scan(t(r1), t(r2), **kw)
        assert got_r.dtype == torch.int32 and got_g.dtype == torch.int32
        want_r, want_g = jref.rerank_scan_ref(jnp.asarray(r1), jnp.asarray(r2))
        eq(got_r, want_r)
        assert int(got_g) == int(want_g)
        ref_r, ref_g = ref.rerank_scan_ref(t(r1), t(r2))
        eq(got_r, ref_r.numpy())
        assert int(got_g) == int(ref_g)
        plain_r, plain_g = rerank_scan_plain(t(r1), t(r2))
        eq(plain_r, got_r.numpy())
        assert int(plain_g) == int(got_g)
        if interpret:
            int_r, int_g = jops.rerank_scan(jnp.asarray(r1), jnp.asarray(r2),
                                            interpret=True, **kw)
            eq(got_r, int_r)
            assert int(got_g) == int(int_g)

    @pytest.mark.parametrize("n", [512, 2048, 3000])
    @pytest.mark.parametrize("vals", [3, 50, 100000])
    def test_vs_interpret_and_refs(self, n, vals):
        self._check(*_sorted_pairs(np.random.default_rng(n + vals), n, vals))

    @pytest.mark.parametrize("block", [256, 512, 1024])
    def test_block_sizes_change_nothing(self, block):
        rng = np.random.default_rng(block)
        r1 = np.sort(rng.integers(0, 9, 4096)).astype(np.int32)
        r2 = rng.integers(0, 9, 4096).astype(np.int32)
        order = np.lexsort((r2, r1))
        self._check(r1[order], r2[order], block=block)

    @pytest.mark.parametrize("case", ["all_equal", "all_distinct", "one",
                                      "groups_cross_blocks"])
    def test_edges(self, case):
        n = 3000                                 # n % 512 != 0
        if case == "all_equal":
            r1 = r2 = np.zeros(n, np.int32)
        elif case == "all_distinct":
            r1, r2 = np.arange(n, dtype=np.int32), np.zeros(n, np.int32)
        elif case == "one":
            r1 = r2 = np.array([5], np.int32)
        else:                                    # runs of 700 straddle 512s
            r1 = (np.arange(n) // 700).astype(np.int32)
            r2 = np.zeros(n, np.int32)
        self._check(r1, r2)

    def test_int32_max_tail(self):
        """A real (INT32_MAX, INT32_MAX) last pair: with n % 512 == 0 the
        reference wrapper pads nothing and agrees; with n % 512 != 0 its
        INT32_MAX pad pairs join that group and it reports one group too
        few (a reference quirk), so that case is held against the oracles
        only."""
        big = 2**31 - 1
        for n, pads in ((2048, False), (3000, True)):
            r1 = np.arange(n, dtype=np.int32)
            r2 = np.zeros(n, np.int32)
            r1[-3:] = r2[-3:] = big
            self._check(r1, r2, interpret=not pads)
            assert int(ops.rerank_scan(t(r1), t(r2))[1]) == n - 2
        _, quirk = jops.rerank_scan(jnp.asarray(r1), jnp.asarray(r2),
                                    interpret=True)
        assert int(quirk) == n - 3

    @pytest.mark.parametrize("n", [1, RERANK_TILE - 1, RERANK_TILE,
                                   RERANK_TILE + 1, 3 * RERANK_TILE + 5])
    @pytest.mark.parametrize("vals", [3, 1000])
    def test_kernel_tile_edges(self, n, vals):
        """Lengths at the edges of the CUDA kernel's tile."""
        self._check(*_sorted_pairs(np.random.default_rng(7 * n + vals), n,
                                   vals))

    @pytest.mark.parametrize("n", [RERANK_TILE + 1, 3 * RERANK_TILE + 5])
    @pytest.mark.parametrize("vals", [3, 1000])
    def test_aliased_operands(self, n, vals):
        """r2 passed as the very same tensor as r1 (the fast rounds'
        re-rank by r1 alone): the kernel then reads one array."""
        r1 = np.sort(np.random.default_rng(n + vals).integers(
            0, vals, n)).astype(np.int32)
        x, j = t(r1), jnp.asarray(r1)
        got_r, got_g = ops.rerank_scan(x, x)
        for want_r, want_g in (jops.rerank_scan(j, j, interpret=True),
                               jref.rerank_scan_ref(j, j),
                               rerank_scan_plain(x, x.clone())):
            eq(got_r, want_r)
            assert int(got_g) == int(want_g)

    @pytest.mark.parametrize("case", ["all_equal", "runs_3_tiles",
                                      "runs_of_97", "one_head_per_tile"])
    def test_long_runs(self, case):
        """Groups longer than three tiles (whole tiles without a head), and
        groups that start in the row of pairs before a tile."""
        n = 4 * RERANK_TILE + 7
        i = np.arange(n)
        if case == "all_equal":
            r1 = np.zeros(n, np.int32)
        elif case == "runs_3_tiles":
            r1 = (i // (3 * RERANK_TILE + 1)).astype(np.int32)
        elif case == "runs_of_97":
            r1 = (i // 97).astype(np.int32)
        else:                                  # heads 100 pairs into a tile
            r1 = ((i + RERANK_TILE - 100) // RERANK_TILE).astype(np.int32)
        self._check(r1, np.full(n, 5, np.int32))

    @pytest.mark.parametrize("n,pads", [(2 * RERANK_TILE, False),
                                        (RERANK_TILE + 2, True)])
    def test_int32_max_tail_at_tile_edge(self, n, pads):
        """An (INT32_MAX, INT32_MAX) group that starts two pairs before the
        kernel's first tile edge and runs to the end.  The reference
        wrapper pads when n % 512 != 0 and then counts one group too few
        (the quirk of test_int32_max_tail), so that case is held against
        the oracles only."""
        big = 2**31 - 1
        r1 = np.arange(n, dtype=np.int32)
        r2 = np.zeros(n, np.int32)
        r1[RERANK_TILE - 2:] = r2[RERANK_TILE - 2:] = big
        self._check(r1, r2, interpret=not pads)
        assert int(ops.rerank_scan(t(r1), t(r2))[1]) == RERANK_TILE - 1
        if pads:
            _, quirk = jops.rerank_scan(jnp.asarray(r1), jnp.asarray(r2),
                                        interpret=True)
            assert int(quirk) == RERANK_TILE - 2

    def test_rerank_from_sorted_matches_reference(self):
        from repro.core.suffix_array import (
            rerank_from_sorted as j_rerank_from_sorted,
        )
        from repro_torch.core.suffix_array import rerank_from_sorted

        for vals in (20, 1 << 20):
            r1, r2 = _sorted_pairs(np.random.default_rng(vals), 2048, vals)
            got, distinct = rerank_from_sorted(t(r1), t(r2))
            want, want_distinct = j_rerank_from_sorted(jnp.asarray(r1),
                                                       jnp.asarray(r2))
            eq(got, want)
            assert distinct == bool(want_distinct)


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
        ops.rerank_scan(keys, keys)
        ops.char_histogram(keys, 1000)
        assert _build.LAUNCHES == before

    def test_resolve_sort_engine(self):
        assert ops.resolve_sort_engine("auto", "cpu") == ops.COMPARE
        assert ops.resolve_sort_engine("auto", "cuda") == ops.RADIX
        assert ops.resolve_sort_engine("radix", "cpu") == ops.RADIX
        with pytest.raises(ValueError):
            ops.resolve_sort_engine("bitonic", "cpu")
