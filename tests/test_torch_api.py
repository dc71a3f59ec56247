"""The port's last public functions of the index modules against the JAX
package's: ``core/competitor.py`` (``suffix_array_rpgi``, ``bwt_rpgi``;
the ``TestCompetitor`` cases of ``tests/test_attention.py`` in both
packages), ``core/bwt.py`` ``bwt``, ``core/suffix_array.py``
``suffix_array_naive`` and ``core/fm_index.py`` ``occ``,
``backward_search``, ``bwt_symbol``, ``locate_naive``, ``count_naive``,
``sample_lookup`` and ``packed_symbol``, on texts at sigma {2, 4, 16, 17}
and the dna / proteins corpora.

Every output is an integer, so the tolerance is exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import alphabet as jal
from repro.core import fm_index as jfm
from repro.core.bwt import bwt as j_bwt
from repro.core.bwt import bwt_from_sa as j_bwt_from_sa
from repro.core.competitor import bwt_rpgi as j_bwt_rpgi
from repro.core.competitor import suffix_array_rpgi as j_suffix_array_rpgi
from repro.core.suffix_array import suffix_array_fast as j_suffix_array_fast
from repro.core.suffix_array import suffix_array_naive as j_sa_naive
from repro_torch.core import alphabet as al
from repro_torch.core import dist_fm
from repro_torch.core import fm_index as fm
from repro_torch.core.bwt import bwt
from repro_torch.core.competitor import bwt_rpgi, suffix_array_rpgi
from repro_torch.core.suffix_array import suffix_array_naive
from repro_torch.data.corpus import corpus
from repro_torch.kernels import fm_query
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

TEXTS = ["sigma2", "sigma4", "sigma16", "sigma17", "dna", "proteins"]


def _text(name: str) -> np.ndarray:
    if name.startswith("sigma"):
        sigma = int(name[5:])
        toks = (np.ones(700, np.int32) if sigma == 2 else
                np.random.default_rng(sigma).integers(1, sigma, 1500)
                .astype(np.int32))
    else:
        toks = corpus(name, 2000)
    return al.append_sentinel(toks)


# --------------------------------------------------------------------------
# the competitor (TestCompetitor's cases, both packages)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_rpgi_matches_naive_and_reference(seed):
    rng = np.random.default_rng(seed)
    s = al.append_sentinel(
        rng.integers(1, rng.integers(2, 7), rng.integers(2, 120))
        .astype(np.int32))
    got = suffix_array_rpgi(torch.from_numpy(s)).numpy()
    assert np.array_equal(got, suffix_array_naive(s))
    assert np.array_equal(got, np.asarray(j_suffix_array_rpgi(
        jnp.asarray(s))))


@pytest.mark.parametrize("prefix_block", [1, 3, 8])
def test_rpgi_repetitive_worst_case(prefix_block):
    s = al.append_sentinel(np.tile([1, 1, 2], 80).astype(np.int32))
    got = suffix_array_rpgi(torch.from_numpy(s), prefix_block=prefix_block)
    assert np.array_equal(got.numpy(), suffix_array_naive(s))
    assert np.array_equal(got.numpy(), np.asarray(j_suffix_array_rpgi(
        jnp.asarray(s), prefix_block=prefix_block)))


def test_rpgi_stops_at_max_passes():
    """Cut at ``max_passes``, the order is the reference's partial one's
    groups: same sort keys, so the same prefix-sorted order of the groups
    that are resolved."""
    s = al.append_sentinel(np.tile([1, 1, 2], 40).astype(np.int32))
    got = suffix_array_rpgi(torch.from_numpy(s), prefix_block=2,
                            max_passes=3).numpy()
    want = np.asarray(j_suffix_array_rpgi(jnp.asarray(s), prefix_block=2,
                                          max_passes=3))
    assert sorted(got.tolist()) == list(range(len(s)))
    key = [tuple(s[i:i + 6]) for i in range(len(s))]
    assert [key[i] for i in got] == [key[i] for i in want]


def test_bwt_rpgi_agrees_with_ours():
    rng = np.random.default_rng(9)
    s = al.append_sentinel(rng.integers(1, 5, 200).astype(np.int32))
    b1, r1 = bwt(torch.from_numpy(s), al.sigma_of(s))
    b2, r2 = bwt_rpgi(torch.from_numpy(s))
    assert torch.equal(b1, b2) and int(r1) == int(r2)
    jb, jr = j_bwt_rpgi(jnp.asarray(s))
    assert np.array_equal(b2.numpy(), np.asarray(jb)) and int(r2) == int(jr)


@pytest.mark.parametrize("name", TEXTS)
def test_bwt_and_naive_sa_match_reference(name):
    s = _text(name)
    sigma = al.sigma_of(s)
    b, r = bwt(torch.from_numpy(s), sigma)
    jb, jr = j_bwt(jnp.asarray(s), jal.sigma_of(s))
    assert np.array_equal(b.numpy(), np.asarray(jb)) and int(r) == int(jr)
    short = s[-300:].copy()
    short[-1] = 0
    assert np.array_equal(suffix_array_naive(short), j_sa_naive(short))
    got = suffix_array_rpgi(torch.from_numpy(s))
    assert np.array_equal(got.numpy(), np.asarray(j_suffix_array_rpgi(
        jnp.asarray(s))))


# --------------------------------------------------------------------------
# the FM index's single-query functions
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def indexes():
    """Per text: (s, sa, the reference's FMIndex, the port's), both from
    the reference's SA and BWT, sample rate 32, SA stride 8."""
    out = {}
    for name in TEXTS:
        s = _text(name)
        sigma = al.sigma_of(s)
        sa, _ = j_suffix_array_fast(jnp.asarray(s), sigma,
                                    local_sort="compare")
        b, row = j_bwt_from_sa(jnp.asarray(s), sa)
        want = jfm.build_fm_index(b, row, sigma, 32, sa=sa, sa_sample_rate=8)
        got = fm.build_fm_index(torch.from_numpy(np.array(b)), int(row),
                                sigma, 32, sa=torch.from_numpy(np.array(sa)),
                                sa_sample_rate=8)
        assert fm.fm_mismatch(got, want) == []
        out[name] = (s, np.array(sa), want, got)
    return out


def _patterns(s, seed: int, count: int = 6):
    rng = np.random.default_rng(seed)
    body = s[:-1]
    pats = []
    for _ in range(count):
        m = int(rng.integers(1, 9))
        st = int(rng.integers(0, len(body) - m))
        pats.append(body[st: st + m])
    pats.append(np.array([1, 999, 1], np.int32))     # out of alphabet
    pats.append(np.array([2, 1, -1, -1], np.int32))  # PAD-padded
    pats.append(np.array([0], np.int32))             # the sentinel
    return pats


@pytest.mark.parametrize("name", TEXTS)
def test_backward_search_and_locate_naive_match_reference(indexes, name):
    s, sa, want, got = indexes[name]
    assert got.bits == (2 if name in ("sigma2", "sigma4") else
                        4 if name in ("sigma16", "dna") else 0)
    for pat in _patterns(s, seed=len(name)):
        sp, ep = fm.backward_search(got, torch.from_numpy(pat))
        jsp, jep = jfm.backward_search(want, jnp.asarray(pat))
        assert (int(sp), int(ep)) == (int(jsp), int(jep)), pat
        pos = fm.locate_naive(got, torch.from_numpy(sa),
                              torch.from_numpy(pat))
        assert np.array_equal(pos.numpy(), np.asarray(jfm.locate_naive(
            want, jnp.asarray(sa), jnp.asarray(pat))))
        if (pat >= 0).all():
            n_occ = fm.count_naive(s[:-1], pat)
            assert n_occ == jfm.count_naive(s[:-1], pat)
            if 0 not in pat and (pat < got.sigma).all():
                assert n_occ == max(int(ep) - int(sp), 0)


@pytest.mark.parametrize("name", TEXTS)
def test_occ_and_bwt_symbol_match_reference(indexes, name):
    s, _, want, got = indexes[name]
    rng = np.random.default_rng(7)
    n = got.n
    for c, p in zip(rng.integers(0, got.sigma, 24),
                    list(rng.integers(0, n + 1, 22)) + [0, n]):
        c, p = np.int32(c), np.int32(p)
        assert int(fm.occ(got, torch.tensor(c), torch.tensor(p))) == int(
            jfm.occ(want, jnp.asarray(c), jnp.asarray(p)))
    rows = rng.integers(0, n, 64).astype(np.int32)
    assert np.array_equal(
        fm.bwt_symbol(got, torch.from_numpy(rows)).numpy(),
        np.asarray(jfm.bwt_symbol(want, jnp.asarray(rows))))
    if got.bits:
        r = got.sample_rate
        assert np.array_equal(
            fm.packed_symbol(got.fused, torch.from_numpy(rows // r),
                             torch.from_numpy(rows % r), sigma=got.sigma,
                             bits=got.bits).numpy(),
            np.asarray(jfm.packed_symbol(want.fused, jnp.asarray(rows // r),
                                         jnp.asarray(rows % r),
                                         sigma=want.sigma, bits=want.bits)))
    marked, val = fm.sample_lookup(
        got.sa_marks, got.sa_mark_ranks, got.sa_vals,
        torch.from_numpy(rows), val_bits=got.sa_val_bits,
        val_scale=got.sa_sample_rate)
    jmarked, jval = jfm.sample_lookup(
        want.sa_marks, want.sa_mark_ranks, want.sa_vals, jnp.asarray(rows),
        val_bits=want.sa_val_bits, val_scale=want.sa_sample_rate)
    assert np.array_equal(marked.numpy(), np.asarray(jmarked))
    m = marked.numpy()
    assert np.array_equal(val.numpy()[m], np.asarray(jval)[m])


def test_re_exports():
    assert fm.sample_lookup is fm_query.sample_lookup
    assert fm.packed_symbol is fm_query.packed_symbol
    assert dist_fm.AXIS == "parts"
