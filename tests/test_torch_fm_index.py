"""The port's FM-index (every FMIndex field, packed and unpacked layouts,
raw and compressed SA sample, counts, locate sets) against the JAX
package's on the same BWT and SA, plus an index carried across packages by
``core/convert.py``.

Every output is an integer, so the tolerance is exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import fm_index as jfm
from repro.core.bwt import bwt_from_sa as j_bwt_from_sa
from repro.core.pipeline import build_index as j_build_index
from repro.core.suffix_array import suffix_array_fast as j_suffix_array_fast
from repro_torch.core import alphabet as al
from repro_torch.core import fm_index as fm
from repro_torch.core.convert import (
    fm_index_from_arrays,
    sequence_index_from_arrays,
    to_numpy,
)
from repro_torch.core.fm_index import PAD, fm_mismatch
from repro_torch.data.corpus import corpus
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

# (name, tokens maker, sample_rate): dna -> 4-bit packed, sigma 4 -> 2-bit
# packed, proteins / english -> unpacked
CASES = {
    "dna": (lambda: corpus("dna", 3000), 64),
    "sigma4": (lambda: np.random.default_rng(4).integers(1, 4, 2500)
               .astype(np.int32), 32),
    "proteins": (lambda: corpus("proteins", 2000), 64),
    "english": (lambda: corpus("english", 2000), 16),
}


@pytest.fixture(scope="module")
def built():
    """Per case: (s, sigma, sa, bwt, row) from the JAX builder."""
    out = {}
    for name, (make, _) in CASES.items():
        s = al.append_sentinel(make())
        sigma = al.sigma_of(s)
        sa, _ = j_suffix_array_fast(jnp.asarray(s), sigma,
                                    local_sort="compare")
        bwt, row = j_bwt_from_sa(jnp.asarray(s), sa)
        out[name] = (s, sigma, np.array(sa), np.array(bwt), int(row))
    return out


def _patterns(s, rng, B=40, L=12):
    pats = np.full((B, L), PAD, np.int32)
    body = s[:-1]
    for b in range(B):
        m = int(rng.integers(1, L + 1))
        st = int(rng.integers(0, len(body) - m))
        pats[b, :m] = body[st: st + m]
    pats[0, :] = PAD                      # all-PAD pattern
    pats[1, 1] = 999                      # out-of-alphabet symbol
    pats[2, 0] = 0                        # the sentinel is not queryable
    return pats


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("compress", [False, None])
def test_fields_counts_locate(built, name, compress):
    s, sigma, sa, bwt, row = built[name]
    r = CASES[name][1]
    want = jfm.build_fm_index(jnp.asarray(bwt), jnp.asarray(row), sigma, r,
                              sa=jnp.asarray(sa), sa_sample_rate=8,
                              compress_sa=compress)
    got = fm.build_fm_index(torch.from_numpy(bwt), row, sigma, r,
                            sa=torch.from_numpy(sa), sa_sample_rate=8,
                            compress_sa=compress)
    assert fm_mismatch(got, want) == []
    assert got.bits == (4 if name == "dna" else 2 if name == "sigma4" else 0)
    assert (got.sa_val_bits > 0) == (compress is None)
    assert np.array_equal(fm.decode_sa_values(got),
                          jfm.decode_sa_values(want))
    pats = _patterns(s, np.random.default_rng(len(s)))
    counts = fm.count(got, torch.from_numpy(pats))
    assert np.array_equal(counts.numpy(),
                          np.asarray(jfm.count(want, jnp.asarray(pats))))
    for k in (1, 6):
        pos, cnt = fm.locate(got, torch.from_numpy(pats), k)
        jpos, jcnt = jfm.locate(want, jnp.asarray(pats), k)
        assert np.array_equal(pos.numpy(), np.asarray(jpos))
        assert np.array_equal(cnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("name", ["dna", "proteins"])
def test_unpacked_layout_forced(built, name):
    s, sigma, sa, bwt, row = built[name]
    want = jfm.build_fm_index(jnp.asarray(bwt), jnp.asarray(row), sigma, 64,
                              pack=False)
    got = fm.build_fm_index(torch.from_numpy(bwt), row, sigma, 64, pack=False)
    assert fm_mismatch(got, want) == []
    assert got.fused is None and got.sa_marks is None


def test_sa_value_packing_matches_reference():
    rng = np.random.default_rng(1)
    for bits in (1, 5, 13, 31):
        q = rng.integers(0, 1 << bits, 333).astype(np.int64)
        words = fm.pack_sa_values(torch.from_numpy(q), bits)
        assert np.array_equal(words.numpy(), jfm.pack_sa_values(q, bits))
        idx = np.concatenate([np.arange(333), [-5, 400]]).astype(np.int32)
        got = fm.unpack_sa_value(words, torch.from_numpy(idx), bits)
        want = jfm.unpack_sa_value(jnp.asarray(words.numpy()),
                                   jnp.asarray(idx), bits)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy()[:333], q)


def test_index_carried_across_by_convert(built):
    """A JAX-built index, handed over as numpy arrays, is field-identical to
    the port's own build and answers the same queries."""
    toks = corpus("dna", 3000)
    jidx = j_build_index(toks, sample_rate=64, sa_sample_rate=8)
    arrays = {name: (None if getattr(jidx.fm, name) is None
                     else np.asarray(getattr(jidx.fm, name)))
              for name in jfm.FM_ARRAY_FIELDS}
    aux = {name: getattr(jidx.fm, name) for name in jfm.FM_AUX_FIELDS}
    carried = sequence_index_from_arrays(arrays, aux, "cpu",
                                         sa=np.asarray(jidx.sa),
                                         text_length=jidx.text_length)
    assert fm_mismatch(carried.fm, jidx.fm) == []
    assert np.array_equal(carried.bwt.numpy(), np.asarray(jidx.bwt))
    assert carried.length == jidx.length
    pats = _patterns(built["dna"][0], np.random.default_rng(9))
    assert np.array_equal(carried.count(pats).numpy(),
                          np.asarray(jidx.count(pats)))
    pos, cnt = carried.locate(pats, 5)
    jpos, jcnt = jidx.locate(pats, 5)
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    # and back: to_numpy -> fm_index_from_arrays is lossless
    a2, x2 = to_numpy(carried.fm)
    assert fm_mismatch(fm_index_from_arrays(a2, x2, "cpu"), carried.fm) == []
    assert x2 == aux
