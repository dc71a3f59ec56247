"""The port's rebuild-free BWT merge (``repro_torch/core/bwt_merge.py`` and
the plain walks of ``kernels/merge_walk.py``) against the JAX package's.

Operands are built by the JAX package from numpy seeds and carried across
with ``convert.fm_index_from_arrays``.  Both packages merge them (k-way
and the pairwise fold), and the results must be bit-identical: every
FMIndex field (``fm_mismatch`` empty), the walks' ``ins`` against the JAX
``_merge_walk`` / ``_kway_walk`` output sliced to the real rows, and the
port's own ``build_index_prepared`` of the concatenated prepared texts.
Every output is an integer, so the tolerance is exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bwt_merge as jbm
from repro.core import fm_index as jfm
from repro.core.pipeline import build_index_prepared as j_build_prepared
from repro.core.pipeline import prepare_tokens as j_prepare_tokens
from repro.kernels import ops as jops
from repro_torch.core import bwt_merge as bm
from repro_torch.core import fm_index as fm
from repro_torch.core.convert import fm_index_from_arrays
from repro_torch.core.fm_index import FM_ARRAY_FIELDS, FM_AUX_FIELDS
from repro_torch.core.pipeline import build_index_prepared, prepare_tokens
from repro_torch.data.corpus import corpus
from repro_torch.kernels import _build, ops
from repro_torch.kernels import merge_walk as mw
from repro_torch.testing import faultinject as fi


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name -> (docs maker, declared sigma, r, SA stride, pack): 2-bit (sigma 2
# at r = 32), 4-bit (sigma 4, dna), unpacked (sigma 16 and 17 reserve the
# pad slot past 16; proteins, english; sigma 4 forced unpacked)
SIZES = (45, 30, 22, 11)


def _uniform(sigma, seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, sigma, n).astype(np.int32) for n in sizes]


def _corpus_docs(kind, sizes):
    return [corpus(kind, n, seed=i) for i, n in enumerate(sizes)]


CASES = {
    "sigma2": (lambda: _uniform(2, 67), 2, 32, 4, None),
    "sigma4": (lambda: _uniform(4, 69), 4, 8, 4, None),
    "sigma4_unpacked": (lambda: _uniform(4, 70), 4, 8, 4, False),
    "sigma16": (lambda: _uniform(16, 83), 16, 8, 4, None),
    "sigma17": (lambda: _uniform(17, 84), 17, 16, 8, None),
    "dna": (lambda: _corpus_docs("dna", (300, 200, 120)), 6, 64, 32, None),
    "proteins": (lambda: _corpus_docs("proteins", (250, 140, 90)), 22, 64,
                 32, None),
    "english": (lambda: _corpus_docs("english", (200, 90, 60)), 257, 16, 8,
                None),
}


def _carry(jf):
    arrays = {n: None if getattr(jf, n) is None else np.asarray(getattr(jf, n))
              for n in FM_ARRAY_FIELDS}
    aux = {n: getattr(jf, n) for n in FM_AUX_FIELDS}
    return fm_index_from_arrays(arrays, aux, "cpu")


_OPERANDS = {}


def _operands(docs, sigma_decl, r, srate, pack=None):
    """(prepared texts, sigma, JAX indexes, the same carried across),
    built once per input (the JAX builds dominate this file's time)."""
    key = (tuple(np.asarray(d, np.int32).tobytes() for d in docs),
           sigma_decl, r, srate, pack)
    if key not in _OPERANDS:
        _OPERANDS[key] = _build_operands(docs, sigma_decl, r, srate, pack)
    return _OPERANDS[key]


def _build_operands(docs, sigma_decl, r, srate, pack):
    preps = []
    for d in docs:
        s, sig = j_prepare_tokens(np.asarray(d, np.int32), r, sigma_decl)
        s_t, sig_t = prepare_tokens(np.asarray(d, np.int32), r, sigma_decl)
        assert np.array_equal(s, s_t) and sig == sig_t
        preps.append(s)
    jfms = [j_build_prepared(s, sig, sample_rate=r, sa_sample_rate=srate,
                             pack=pack).fm for s in preps]
    return preps, sig, jfms, [_carry(j) for j in jfms]


def _rebuild(preps, sig, r, srate, pack=None):
    return build_index_prepared(np.concatenate(preps), sig, sample_rate=r,
                                sa_sample_rate=srate, pack=pack,
                                device="cpu").fm


def _same(got, want, what=""):
    assert not (d := fm.fm_mismatch(got, want)), (what, d)


def _jax_pair_ins(left, right):
    """``_merge_walk`` called as ``merge_fm_indexes`` calls it, sliced to
    the right operand's real rows."""
    fA, bA, oA = jbm._side_arrays(left, jfm._next_pow2(left.n_blocks))
    fB, bB, oB = jbm._side_arrays(right, jfm._next_pow2(right.n_blocks))
    ins = jbm._merge_walk(
        fA, bA, oA, left.c_array, jnp.asarray(left.n_blocks, jnp.int32),
        left.row, left.bwt[left.row],
        fB, bB, oB, right.c_array, jnp.asarray(right.n_blocks, jnp.int32),
        right.row, right.bwt[right.row], jnp.asarray(right.length, jnp.int32),
        sigma=left.sigma, bits=left.bits, r=left.sample_rate)
    return np.asarray(ins)[: right.length]


def _jax_kway_ins(jfms):
    """``_kway_walk`` as ``merge_kway`` calls it: segments 1 .. k-1 at
    their real lengths, back to back."""
    k = len(jfms)
    k_pad = jfm._next_pow2(k)
    fused, blocks, occ, c_mat, nb_vec, _ = jfm.stack_rank_arrays(
        jfms, seg_pad=k_pad)
    pad = [0] * (k_pad - k)
    rows = [int(f.row) for f in jfms]
    lasts = [int(np.asarray(f.bwt)[rows[i]]) for i, f in enumerate(jfms)]
    lens = [f.length for f in jfms]
    f0 = jfms[0]
    ins = np.asarray(jbm._kway_walk(
        fused, blocks, occ, c_mat, nb_vec,
        jnp.asarray(np.array(rows + pad, np.int32)),
        jnp.asarray(np.array(lasts + pad, np.int32)),
        jnp.asarray(np.array(lens + pad, np.int32)),
        jnp.asarray(k, jnp.int32),
        sigma=f0.sigma, bits=f0.bits, r=f0.sample_rate, k_pad=k_pad))
    return np.concatenate([ins[s, : lens[s]] for s in range(1, k)])


def _pair_ins(left, right):
    clf, ends = bm._pairwise_walk_inputs(left, right)
    rows = bm._rank_rows(left)
    return mw.merge_walk(*rows, left.c_array, right.c_array, clf, ends,
                         sigma=left.sigma, bits=left.bits,
                         r=left.sample_rate)


def _kway_ins(fms):
    f0 = fms[0]
    return mw.kway_walk(*bm._kway_walk_inputs(fms), sigma=f0.sigma,
                        bits=f0.bits, r=f0.sample_rate)


def _check_kway(docs, sigma_decl, r, srate, pack=None):
    preps, sig, jfms, tfms = _operands(docs, sigma_decl, r, srate, pack)
    for i in range(len(preps) - 1):          # the walk's precondition
        assert bm.context_order_safe(preps[i], np.concatenate(preps[i + 1:]))
    assert np.array_equal(_kway_ins(tfms).numpy(), _jax_kway_ins(jfms))
    got = bm.merge_kway(tfms, pack=pack)
    _same(got, jbm.merge_kway(jfms, pack=pack), "kway vs JAX")
    _same(got, _rebuild(preps, sig, r, srate, pack), "kway vs rebuild")
    return got, preps, sig, jfms, tfms


def _check_fold(docs, sigma_decl, r, srate, pack=None):
    """The pairwise fold as the catalog folds a run: the accumulator
    starts from the last document, each earlier one merges in on its
    left (so the right operand is multi-document from the second fold)."""
    preps, sig, jfms, tfms = _operands(docs, sigma_decl, r, srate, pack)
    acc, jacc = tfms[-1], jfms[-1]
    for left, jleft in zip(reversed(tfms[:-1]), reversed(jfms[:-1])):
        assert np.array_equal(_pair_ins(left, acc).numpy(),
                              _jax_pair_ins(jleft, jacc))
        acc = bm.merge_fm_indexes(left, acc, pack=pack)
        jacc = jbm.merge_fm_indexes(jleft, jacc, pack=pack)
        _same(acc, jacc, "fold step vs JAX")
    _same(acc, _rebuild(preps, sig, r, srate, pack), "fold vs rebuild")
    return acc


@pytest.mark.parametrize("name", list(CASES))
def test_kway_matches_reference(name):
    make, sigma_decl, r, srate, pack = CASES[name]
    got = _check_kway(make(), sigma_decl, r, srate, pack)[0]
    assert got.bits == (0 if pack is False else
                        {"sigma2": 2, "sigma4": 4, "dna": 4}.get(name, 0))


@pytest.mark.parametrize("name", list(CASES))
def test_fold_matches_reference(name):
    make, sigma_decl, r, srate, pack = CASES[name]
    _check_fold(make(), sigma_decl, r, srate, pack)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 7, 8, 9, 33])
def test_kway_any_run_length(k):
    """Non-power-of-two runs, k > 8 (16 lanes) and k > 32 (64 lanes)."""
    rng = np.random.default_rng(100 + k)
    # prepared lengths 8 to 64: few distinct shapes for the JAX builds
    sizes = rng.choice([5, 13, 29, 61], k, p=[0.4, 0.3, 0.2, 0.1])
    docs = [rng.integers(1, 4, int(n)).astype(np.int32) for n in sizes]
    _check_kway(docs, 4, 8, 4)


class TestEdgeCases:
    """The corner cases of the JAX package's merge tests: empty and
    one-symbol documents, SA-value width growing across a merge, and a
    multi-document right operand."""

    @pytest.mark.parametrize("order", ["body_empty", "empty_body",
                                       "empty_empty"])
    def test_empty_document(self, order):
        body = np.random.default_rng(31).integers(1, 5, 20).astype(np.int32)
        docs = {"body_empty": [body, []], "empty_body": [[], body],
                "empty_empty": [[], []]}[order]
        _check_fold(docs, 5, 8, 4)
        _check_kway(docs, 5, 8, 4)

    def test_single_symbol_documents(self):
        _check_fold([[1], [1], [1]], 3, 8, 4)
        _check_kway([[1], [1], [1]], 3, 8, 4)

    def test_sa_val_bits_grows_across_merge(self):
        rng = np.random.default_rng(33)
        docs = [rng.integers(1, 5, 27).astype(np.int32) for _ in range(2)]
        _, _, _, tfms = _operands(docs, 5, 8, 4)
        assert {f.sa_val_bits for f in tfms} == {3}   # 32 rows / 4 -> 7
        assert _check_fold(docs, 5, 8, 4).sa_val_bits == 4
        assert _check_kway(docs, 5, 8, 4)[0].sa_val_bits == 4

    @pytest.mark.parametrize("name", ["dna", "proteins"])
    def test_multi_document_right_operand(self, name):
        """The right operand built over two prepared documents at once."""
        make, sigma_decl, r, srate, _ = CASES[name]
        docs = make()
        preps, sig, jfms, tfms = _operands(docs[:1], sigma_decl, r, srate)
        rest = [j_prepare_tokens(d, r, sigma_decl)[0] for d in docs[1:]]
        jright = j_build_prepared(np.concatenate(rest), sig, sample_rate=r,
                                  sa_sample_rate=srate).fm
        right = _carry(jright)
        assert np.array_equal(_pair_ins(tfms[0], right).numpy(),
                              _jax_pair_ins(jfms[0], jright))
        got = bm.merge_fm_indexes(tfms[0], right)
        _same(got, jbm.merge_fm_indexes(jfms[0], jright))
        _same(got, _rebuild(preps + rest, sig, r, srate))


def test_eligibility_reasons_equal():
    rng = np.random.default_rng(5)
    d = rng.integers(1, 4, 20).astype(np.int32)
    _, _, (j8,), (t8,) = _operands([d], 4, 8, 4)
    _, _, (j16,), (t16,) = _operands([d], 4, 16, 4)
    _, _, (jst,), (tst,) = _operands([d], 4, 8, 16)     # 24 % 16 != 0
    s = np.concatenate([d, [0]]).astype(np.int32)       # 21: no padding
    jodd = j_build_prepared(s, 5, sample_rate=8, sa_sample_rate=4).fm
    todd = _carry(jodd)
    jno, tno = (dataclasses.replace(f, sa_marks=None) for f in (j8, t8))
    pairs = [("x", j8, "x", t8), (j8, None, t8, None), (j8, j16, t8, t16),
             (jodd, j8, todd, t8), (j8, jodd, t8, todd), (j8, jno, t8, tno),
             (jst, jst, tst, tst), (j8, j8, t8, t8)]
    reasons = []
    for ja, jb, ta, tb in pairs:
        want = jbm.merge_eligible(ja, jb)
        assert bm.merge_eligible(ta, tb) == want
        reasons.append(want)
    assert reasons[-1] is None and all(reasons[:-1])
    runs = [([j8], [t8]), ([j8, "x"], [t8, "x"]), ([j8, j16], [t8, t16]),
            ([j8, jodd], [t8, todd]), ([jodd, j8], [todd, t8]),
            ([j8, jno], [t8, tno]),
            ([jst, j8], [tst, t8]), ([j8, jst], [t8, tst]),
            ([j8, j8, j8], [t8, t8, t8])]
    for jr, tr in runs:
        assert bm.kway_eligible(tr) == jbm.kway_eligible(jr)
    with pytest.raises(ValueError, match="cannot merge: mixed layouts"):
        bm.merge_fm_indexes(t8, t16)
    with pytest.raises(ValueError, match="cannot merge: k-way merge needs"):
        bm.merge_kway([t8])


def test_context_order_safe_and_walk_steps_equal():
    rng = np.random.default_rng(11)
    sent = np.array([0], np.int32)
    tail = np.full(7, 3, np.int32)
    unsafe = np.concatenate([tail, sent, np.full(7, 1, np.int32), sent])
    cases = [(unsafe, unsafe), (unsafe, unsafe[::-1].copy()), ([], unsafe),
             (unsafe, []), (np.ones(50, np.int32), np.ones(3, np.int32))]
    for _ in range(20):
        a = rng.integers(0, 3, int(rng.integers(1, 40))).astype(np.int32)
        b = rng.integers(0, 3, int(rng.integers(1, 40))).astype(np.int32)
        cases.append((a, b))
    got = []
    for a, b in cases:
        for budget in (1 << 24, 3):
            want = jbm.context_order_safe(a, b, budget=budget)
            assert bm.context_order_safe(a, b, budget=budget) == want
            got.append(want)
    assert True in got and False in got
    for lens in ([], [64], [64, 128], [640, 64, 64, 192], [8] * 33):
        assert bm.kway_walk_steps(lens) == jbm.kway_walk_steps(lens)


@pytest.mark.parametrize("name", ["dna", "sigma2", "proteins"])
@pytest.mark.parametrize("pads", [None, (8, 16)])
def test_stack_rank_arrays_and_rank_walkers_equal(name, pads):
    make, sigma_decl, r, srate, pack = CASES[name]
    _, sig, jfms, tfms = _operands(make()[:3], sigma_decl, r, srate, pack)
    kw = {} if pads is None else dict(seg_pad=pads[0], blocks_pad=pads[1])
    want = jfm.stack_rank_arrays(jfms, **kw)
    got = fm.stack_rank_arrays(tfms, **kw)
    for w, g in zip(want[:5], got[:5]):
        assert (w is None) == (g is None)
        if w is not None:
            assert np.array_equal(np.asarray(w), g.numpy())
    assert want[5] == got[5]
    fused, blocks, occ, _, nb_vec, NB = got
    rng = np.random.default_rng(7)
    B = 200
    seg = rng.integers(0, len(tfms), B)
    blk = rng.integers(0, nb_vec.numpy()[seg])
    args = [(seg * NB + blk).astype(np.int32),
            rng.integers(0, sig, B).astype(np.int32),
            rng.integers(0, r + 1, B).astype(np.int32)]
    bits = tfms[0].bits
    j = jops.rank_walkers(*want[:3], *map(jnp.asarray, args), bits=bits,
                          sigma=sig)
    t = ops.rank_walkers(fused, blocks, occ, *map(torch.from_numpy, args),
                         bits=bits, sigma=sig)
    assert np.array_equal(np.asarray(j), t.numpy())


def test_sample_marked_rows_and_sa_values_equal():
    """Raw and bit-packed SA values; mark words with bit 31 set (negative
    as int32) included."""
    negative = 0
    dense = [np.random.default_rng(3).integers(1, 4, 600).astype(np.int32)]
    for docs, sigma_decl, r, srate in ((CASES["proteins"][0](), 22, 64, 32),
                                       (dense, 4, 8, 4)):
        _, _, jfms, tfms = _operands(docs, sigma_decl, r, srate)
        for jf, tf in zip(jfms, tfms):
            negative += int((tf.sa_marks < 0).sum())
            assert np.array_equal(fm.sample_marked_rows(tf).numpy(),
                                  jfm.sample_marked_rows(jf))
            assert np.array_equal(fm.sa_values(tf).numpy(),
                                  jfm.decode_sa_values(jf))
    assert negative > 0
    assert fm._next_pow2(1) == jfm._next_pow2(1) == 1
    assert fm._next_pow2(9) == jfm._next_pow2(9) == 16


@pytest.mark.parametrize("point,flavour", [("merge.mid", "pairwise"),
                                           ("merge.kway", "kway"),
                                           ("merge.mid", "kway")])
def test_fault_points_fire_and_leave_operands_untouched(point, flavour):
    make, sigma_decl, r, srate, _ = CASES["dna"]
    _, _, _, tfms = _operands(make(), sigma_decl, r, srate)
    before = [{n: None if getattr(f, n) is None else getattr(f, n).clone()
               for n in FM_ARRAY_FIELDS} for f in tfms]
    sched = fi.FaultSchedule([f"{point}:0"])
    with fi.inject(sched), pytest.raises(fi.InjectedFault, match=point):
        if flavour == "pairwise":
            bm.merge_fm_indexes(tfms[0], tfms[1])
        else:
            bm.merge_kway(tfms)
    assert sched.fired == [(point, 0)]
    if flavour == "kway":
        assert sched.hits == ({"merge.kway": 1} if point == "merge.kway"
                              else {"merge.kway": 1, "merge.mid": 1})
    for f, b in zip(tfms, before):
        for n in FM_ARRAY_FIELDS:
            assert (b[n] is None) == (getattr(f, n) is None)
            if b[n] is not None:
                assert torch.equal(getattr(f, n), b[n]), n
    bm.merge_kway(tfms)                       # disarmed: merges again


def test_no_plain_walk_for_non_cpu_tensors(monkeypatch):
    """Tensors off the CPU never take the plain walk: mixed devices raise
    ValueError, and non-CPU tensors go to the CUDA argument check (which
    refuses anything but contiguous int32 CUDA tensors) before any
    library is requested."""
    def no_library(name):
        raise AssertionError(f"kernel library {name} requested")

    monkeypatch.setattr(_build, "library", no_library)
    make, sigma_decl, r, srate, _ = CASES["proteins"]
    _, _, _, (a, b, c) = _operands(make(), sigma_decl, r, srate)
    clf, ends = bm._pairwise_walk_inputs(a, b)
    rows = bm._rank_rows(a)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="different devices"):
        mw.merge_walk(*rows, a.c_array, b.c_array, clf.to("meta"), ends,
                      sigma=a.sigma, bits=a.bits, r=r)
    meta = [None if t is None else t.to("meta") for t in rows]
    with pytest.raises(ValueError, match="CUDA"):
        mw.merge_walk(*meta, a.c_array.to("meta"), b.c_array.to("meta"),
                      clf.to("meta"), ends.to("meta"), sigma=a.sigma,
                      bits=a.bits, r=r)
    args = [None if t is None else t.to("meta") if torch.is_tensor(t) else t
            for t in bm._kway_walk_inputs([a, b, c])]
    with pytest.raises(ValueError, match="CUDA"):
        mw.kway_walk(*args, sigma=a.sigma, bits=a.bits, r=r)
    on_meta = fm.FMIndex(**{
        n: (getattr(c, n).to("meta") if n in FM_ARRAY_FIELDS
            and getattr(c, n) is not None else getattr(c, n))
        for n in FM_ARRAY_FIELDS + FM_AUX_FIELDS})
    with pytest.raises(ValueError, match="different devices"):
        bm.merge_fm_indexes(a, on_meta)
    with pytest.raises(ValueError, match="different devices"):
        bm.merge_kway([a, b, on_meta])
    assert _build.LAUNCHES == before
