"""The port's stacked segment catalog (``repro_torch/core/fm_index.py``:
``stack_fm_indexes``, ``stacked_append``, ``stacked_replace_run``,
``count_stacked``, ``locate_stacked``, and the plain versions of the
stacked query kernels in ``kernels/fm_query.py``) against the JAX
package's.

Segments are built by the JAX package from numpy seeds (segments of 57 to
200 tokens, r = 8 or 16, SA stride 4) and carried across with
``convert.fm_index_from_arrays``; both packages stack, grow and query them.
Every output is an integer, so the tolerance is exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fm_index as jfm
from repro.core.pipeline import build_index as j_build_index
from repro.core.pipeline import build_index_prepared as j_build_prepared
from repro.core.pipeline import prepare_tokens as j_prepare_tokens
from repro_torch.core import fm_index as fm
from repro_torch.core.convert import fm_index_from_arrays
from repro_torch.core.fm_index import FM_ARRAY_FIELDS, FM_AUX_FIELDS, PAD
from repro_torch.data.corpus import corpus
from repro_torch.kernels import _build
from repro_torch.kernels import fm_query as fq


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIZES = (200, 90, 57)
SA_RATE = 4
# name -> (declared sigma, r, documents): 2-bit rows (sigma 2 + pad at
# r = 16), 4-bit (sigma 2 and 4 at r = 8), unpacked (sigma 16 and 17 past
# the pad slot; proteins)
CASES = {
    "sigma2_2bit": (2, 16, None),
    "sigma2": (2, 8, None),
    "sigma4": (4, 8, None),
    "sigma16": (16, 8, None),
    "sigma17": (17, 8, None),
    "proteins": (22, 8, "proteins"),
}
STACK_ARRAYS = ("fused", "blocks", "occ", "c_array", "n_blocks", "lengths",
                "sa_marks", "sa_mark_ranks", "sa_vals")
STACK_STATIC = ("seg_pad", "blocks_pad", "sample_rate", "sigma", "bits",
                "sa_sample_rate")


def _docs(name):
    sigma, _, kind = CASES[name]
    if kind:
        return [corpus(kind, n, seed=i) for i, n in enumerate(SIZES)]
    rng = np.random.default_rng(sigma * 7 + len(name))
    return [rng.integers(1, sigma, n).astype(np.int32) for n in SIZES]


def _carry(jf):
    arrays = {n: None if getattr(jf, n) is None else np.asarray(getattr(jf, n))
              for n in FM_ARRAY_FIELDS}
    aux = {n: getattr(jf, n) for n in FM_AUX_FIELDS}
    return fm_index_from_arrays(arrays, aux, "cpu")


@pytest.fixture(scope="module")
def segments():
    """name -> (documents, JAX indexes, the same carried across, a JAX
    index of the first two documents' prepared texts: a merged segment)."""
    out = {}
    for name, (sigma, r, _) in CASES.items():
        docs = _docs(name)
        jfms = [j_build_index(d, sample_rate=r, sa_sample_rate=SA_RATE,
                              sigma=sigma).fm for d in docs]
        preps = [j_prepare_tokens(d, r, sigma) for d in docs[:2]]
        merged = j_build_prepared(
            np.concatenate([p[0] for p in preps]), preps[0][1],
            sample_rate=r, sa_sample_rate=SA_RATE).fm
        out[name] = (docs, jfms, [_carry(f) for f in jfms], merged)
    return out


def _patterns(docs, sigma, seed, B=24, L=6):
    """Substrings of the documents, random and out-of-alphabet symbols, an
    all-PAD row and a PAD inside a pattern."""
    rng = np.random.default_rng(seed)
    pats = np.full((B, L), PAD, np.int32)
    for b in range(B - 4):
        d = docs[b % len(docs)]
        m = int(rng.integers(1, L + 1))
        st = int(rng.integers(0, len(d) - m))
        pats[b, :m] = d[st: st + m]
    pats[B - 4, :3] = rng.integers(1, sigma, 3)
    pats[B - 3, :2] = (sigma + 3, 1)
    pats[B - 2, :4] = (1, PAD, 1, 1)
    return pats          # row B - 1 stays all PAD


def assert_same_stack(got, want, what=""):
    for name in STACK_ARRAYS:
        x, y = getattr(got, name), getattr(want, name)
        assert (x is None) == (y is None), (what, name)
        if x is not None:
            y = np.asarray(y)
            assert tuple(x.shape) == y.shape, (what, name)
            assert np.array_equal(x.numpy(), y), (what, name)
    assert got.n_seg == int(want.n_seg), what
    for name in STACK_STATIC:
        assert getattr(got, name) == getattr(want, name), (what, name)


@pytest.mark.parametrize("name", list(CASES))
def test_stack_fields_match_reference(segments, name):
    _, jfms, tfms, _ = segments[name]
    for kw in ({}, {"seg_pad": 8}, {"blocks_pad": 64}):
        assert_same_stack(fm.stack_fm_indexes(tfms, **kw),
                          jfm.stack_fm_indexes(jfms, **kw), (name, kw))


@pytest.mark.parametrize("name", list(CASES))
def test_count_locate_stacked_match_reference(segments, name):
    docs, jfms, tfms, _ = segments[name]
    sigma = CASES[name][0]
    js, ts = jfm.stack_fm_indexes(jfms), fm.stack_fm_indexes(tfms)
    pats = _patterns(docs, sigma, seed=sigma)
    want = np.asarray(jfm.count_stacked(js, jnp.asarray(pats)))
    got = fm.count_stacked(ts, torch.from_numpy(pats))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for k in (1, 4, 64):
        wp, wc = jfm.locate_stacked(js, jnp.asarray(pats), k)
        gp, gc = fm.locate_stacked(ts, torch.from_numpy(pats), k)
        assert np.array_equal(gp.numpy(), np.asarray(wp)), k
        assert np.array_equal(gc.numpy(), np.asarray(wc)), k


@pytest.mark.parametrize("name", ["sigma2_2bit", "sigma4", "sigma17"])
def test_rows_are_the_segments_own_answers(segments, name):
    """Row s of the plain stacked query is the single-index plain query of
    segment s (sp, ep and unsorted positions); pad rows are zero."""
    docs, _, tfms, _ = segments[name]
    st = fm.stack_fm_indexes(tfms, seg_pad=4)
    pats = torch.from_numpy(_patterns(docs, CASES[name][0], seed=3))
    stacked = (fq.fm_query_stacked_packed_plain if st.bits
               else fq.fm_query_stacked_unpacked_plain)
    single = (fq.fm_query_packed_plain if st.bits
              else fq.fm_query_unpacked_plain)
    for k in (0, 5):
        sp, ep, pos = stacked(st, pats, k)
        assert sp.shape == ep.shape == (4, pats.shape[0])
        assert pos.shape == (4, pats.shape[0], k)
        for s, f in enumerate(tfms):
            want = single(f, pats, k)
            for got_part, want_part in zip((sp[s], ep[s], pos[s]), want):
                assert torch.equal(got_part, want_part), (s, k)
        assert not sp[3].any() and not ep[3].any() and not pos[3].any()


@pytest.mark.parametrize("name", list(CASES))
def test_append_and_replace_match_reference(segments, name):
    _, jfms, tfms, merged = segments[name]
    js = jfm.stack_fm_indexes(jfms[:2], seg_pad=4, blocks_pad=64)
    ts = fm.stack_fm_indexes(tfms[:2], seg_pad=4, blocks_pad=64)
    js, ts = jfm.stacked_append(js, jfms[2]), fm.stacked_append(ts, tfms[2])
    assert_same_stack(ts, js, "append")
    # the merged first two documents replace segments [0, 2)
    jr = jfm.stacked_replace_run(js, 0, 2, merged)
    tr = fm.stacked_replace_run(ts, 0, 2, _carry(merged))
    assert_same_stack(tr, jr, "replace [0, 2)")
    assert tr.n_seg == 2
    # and a run in the middle of the catalog: [1, 3) -> segment 2
    jr = jfm.stacked_replace_run(js, 1, 2, jfms[2])
    tr = fm.stacked_replace_run(ts, 1, 2, tfms[2])
    assert_same_stack(tr, jr, "replace [1, 3)")
    with pytest.raises(ValueError, match="bad run"):
        fm.stacked_replace_run(ts, 2, 2, tfms[0])


def test_pad_segments_answer_nothing(segments):
    """Pad segments (n_blocks 1, length 0) count zero and locate nothing
    (positions filled with their length 0), as the reference's."""
    docs, jfms, tfms, _ = segments["sigma4"]
    ts = fm.stack_fm_indexes(tfms, seg_pad=8)
    js = jfm.stack_fm_indexes(jfms, seg_pad=8)
    assert ts.n_blocks[3:].tolist() == [1] * 5
    assert ts.lengths[3:].tolist() == [0] * 5
    pats = _patterns(docs, 4, seed=11)
    counts = fm.count_stacked(ts, torch.from_numpy(pats))
    assert not counts[3:].any() and counts[:3].sum() > 0
    pos, cnt = fm.locate_stacked(ts, torch.from_numpy(pats), 6)
    assert not pos[3:].any() and not cnt[3:].any()
    wp, _ = jfm.locate_stacked(js, jnp.asarray(pats), 6)
    assert np.array_equal(pos.numpy(), np.asarray(wp))


def test_append_that_fits_does_not_reallocate(segments):
    """An append into spare capacity writes in place: every bucket tensor
    keeps its storage, and the old object's n_seg is the stale one."""
    _, _, tfms, _ = segments["sigma17"]
    st = fm.stack_fm_indexes(tfms[:1], seg_pad=4, blocks_pad=64)
    ptrs = {n: getattr(st, n).data_ptr() for n in STACK_ARRAYS
            if getattr(st, n) is not None}
    grown = fm.stacked_append(fm.stacked_append(st, tfms[1]), tfms[2])
    assert grown.n_seg == 3 and st.n_seg == 1
    assert {n: getattr(grown, n).data_ptr() for n in ptrs} == ptrs
    assert_same_stack(grown, jfm.stack_fm_indexes(
        segments["sigma17"][1], seg_pad=4, blocks_pad=64))


def test_full_or_misfit_append_raises_and_writes_nothing(segments):
    _, _, tfms, _ = segments["sigma4"]
    st = fm.stack_fm_indexes(tfms[:2])                 # seg_pad 2: full
    before = {n: getattr(st, n).clone() for n in STACK_ARRAYS
              if getattr(st, n) is not None}
    with pytest.raises(ValueError, match="full"):
        fm.stacked_append(st, tfms[2])
    small = fm.stack_fm_indexes(tfms[2:], seg_pad=4, blocks_pad=8)
    with pytest.raises(ValueError, match="exceed bucket"):
        fm.stacked_append(small, tfms[0])
    other = segments["sigma17"][2][0]                 # another layout
    with pytest.raises(ValueError, match="does not match"):
        fm.stacked_append(fm.stack_fm_indexes(tfms, seg_pad=4), other)
    for n, t in before.items():
        assert torch.equal(getattr(st, n), t), n


def test_mixed_catalog_refuses_to_stack(segments):
    with pytest.raises(ValueError, match="mixed segment layouts"):
        fm.stack_fm_indexes([segments["sigma4"][2][0],
                             segments["sigma17"][2][0]])
    with pytest.raises(ValueError, match="empty"):
        fm.stack_fm_indexes([])
    st = fm.stack_fm_indexes(segments["sigma4"][2])
    with pytest.raises(ValueError, match="no locate"):
        fm.locate_stacked(dataclasses.replace(st, sa_sample_rate=0),
                          torch.zeros((1, 2), dtype=torch.int32), 2)


def test_stacked_wrappers_take_the_plain_version_on_the_cpu(segments,
                                                            monkeypatch):
    """CPU tensors reach no kernel library and count no launch; the
    stacked kernels' C entries are registered and built from one
    source."""
    def no_library(name):
        raise AssertionError(f"kernel library {name} requested")

    monkeypatch.setattr(_build, "library", no_library)
    before = dict(_build.LAUNCHES)
    docs, _, tfms, _ = segments["sigma4"]
    st = fm.stack_fm_indexes(tfms)
    pats = torch.from_numpy(_patterns(docs, 4, seed=5))
    fm.count_stacked(st, pats)
    fm.locate_stacked(st, pats, 3)
    assert _build.LAUNCHES == before
    for name in ("fm_query_stacked_packed", "fm_query_stacked_unpacked"):
        assert _build.KERNELS[name] == "fm_query_stacked"
        assert name in _build.KERNELS and name in _build.SIGNATURES
    assert "fm_query_stacked" in _build.SOURCES
