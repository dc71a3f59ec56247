"""The fused FM query (``repro_torch/kernels/fm_query.py``): its plain
versions, which CPU tensors take, against the JAX package's backward
search, ``count`` and ``locate`` on the same BWT and SA; the CUDA-path
argument checks; and the kernel sources' C entry points against the
ctypes signatures that bind them.

Corpora: random texts at sigma 2, 4 (2-bit packed), 16 (4-bit packed)
and 17 (unpacked), plus ``data/corpus.py`` proteins and english
(unpacked); raw and bit-packed SA values.  Every output is an integer, so
the tolerance is exact equality.
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import fm_index as jfm
from repro.core.bwt import bwt_from_sa as j_bwt_from_sa
from repro.core.suffix_array import suffix_array_fast as j_suffix_array_fast
from repro_torch.core import alphabet as al
from repro_torch.core import fm_index as fm
from repro_torch.data.corpus import corpus
from repro_torch.kernels import _build, fm_query, ops
from repro_torch.kernels.fm_query import PAD


def _random(sigma, n, seed):
    return lambda: np.random.default_rng(seed).integers(
        1, sigma, n).astype(np.int32)


# name: (tokens maker, sample_rate, packed field bits expected)
CASES = {
    "sigma2": (_random(2, 700, 2), 32, 2),
    "sigma4": (_random(4, 1500, 4), 32, 2),
    "sigma16": (_random(16, 1500, 16), 64, 4),
    "sigma17": (_random(17, 1500, 17), 64, 0),
    "proteins": (lambda: corpus("proteins", 1500), 64, 0),
    "english": (lambda: corpus("english", 1500), 16, 0),
}
KS = (1, 16, 64)


@pytest.fixture(scope="module")
def built():
    """Per case: (text, sigma, sa, bwt, row) from the JAX builder."""
    out = {}
    for name, (make, _, _) in CASES.items():
        toks = make()
        s = al.append_sentinel(toks)
        sigma = al.sigma_of(s)
        sa, _ = j_suffix_array_fast(jnp.asarray(s), sigma,
                                    local_sort="compare")
        bwt, row = j_bwt_from_sa(jnp.asarray(s), sa)
        out[name] = (toks, sigma, np.array(sa), np.array(bwt), int(row))
    return out


def _patterns(toks, sigma, rng):
    """Substrings of lengths 1-24, then the edge patterns: all-PAD, length
    1 for some symbols, lengths 64 and 128, the sentinel 0 alone and
    inside, symbols at and past sigma, a negative one, a PAD inside, and
    random (absent) patterns; PAD-padded to width 128."""
    pats = []
    for _ in range(24):
        m = int(rng.integers(1, 25))
        st = int(rng.integers(0, len(toks) - m))
        pats.append(toks[st: st + m])
    pats += [np.zeros(0, np.int32), np.array([0], np.int32)]
    pats += [np.array([c], np.int32) for c in range(1, min(sigma, 6))]
    for m in (64, 128):
        st = int(rng.integers(0, len(toks) - m))
        pats.append(toks[st: st + m])
    for bad in (0, sigma, sigma + 5, 999, -2, PAD):
        p = toks[100:112].copy()
        p[5] = bad
        pats.append(p)
    pats += [rng.integers(1, sigma, 40).astype(np.int32) for _ in range(3)]
    out = np.full((len(pats), 128), PAD, np.int32)
    for i, p in enumerate(pats):
        out[i, : len(p)] = p
    return out


@pytest.fixture
def no_kernels(monkeypatch):
    """CPU index tensors must reach no kernel library and count no
    launch."""
    def no_library(name):
        raise AssertionError(f"kernel library {name} requested")

    monkeypatch.setattr(_build, "library", no_library)
    before = dict(_build.LAUNCHES)
    yield
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("compress", [False, True])
def test_plain_matches_reference(built, no_kernels, name, compress):
    toks, sigma, sa, bwt, row = built[name]
    r, bits = CASES[name][1:]
    want = jfm.build_fm_index(jnp.asarray(bwt), jnp.asarray(row), sigma, r,
                              sa=jnp.asarray(sa), sa_sample_rate=8,
                              compress_sa=compress)
    got = fm.build_fm_index(torch.from_numpy(bwt), row, sigma, r,
                            sa=torch.from_numpy(sa), sa_sample_rate=8,
                            compress_sa=compress)
    assert got.bits == bits and (got.sa_val_bits > 0) == compress
    plain = (fm_query.fm_query_packed_plain if bits
             else fm_query.fm_query_unpacked_plain)
    wrapper = ops.fm_query_packed if bits else ops.fm_query_unpacked
    pats = _patterns(toks, sigma, np.random.default_rng(len(toks) + sigma))
    P, jP = torch.from_numpy(pats), jnp.asarray(pats)

    jsp, jep = jfm.backward_search_batch(want, jP)
    sp, ep, pos = plain(got, P)
    assert np.array_equal(sp.numpy(), np.asarray(jsp))
    assert np.array_equal(ep.numpy(), np.asarray(jep))
    assert pos.shape == (len(pats), 0)
    jcount = np.asarray(jfm.count(want, jP))
    assert np.array_equal(fm.count(got, P).numpy(), jcount)
    assert jcount.max() > 64 and (jcount == 0).any()     # both edges hit
    for k in KS:
        sp, ep, pos = plain(got, P, k)
        w2 = wrapper(got, P, k)
        assert all(torch.equal(a, b) for a, b in zip((sp, ep, pos), w2))
        jpos, jcnt = jfm.locate(want, jP, k)
        assert np.array_equal(torch.sort(pos, dim=1).values.numpy(),
                              np.asarray(jpos))
        lpos, lcnt = fm.locate(got, P, k)
        assert np.array_equal(lpos.numpy(), np.asarray(jpos))
        assert np.array_equal(lcnt.numpy(), np.asarray(jcnt))


def test_plain_takes_any_rank(built, no_kernels):
    """The step loop over a caller's rank function (how the earlier
    one-launch-per-step design is timed on the card) gives the same
    answers; every rank call gets one batch of queries."""
    toks, sigma, sa, bwt, row = built["sigma4"]
    index = fm.build_fm_index(torch.from_numpy(bwt), row, sigma, 32,
                              sa=torch.from_numpy(sa), sa_sample_rate=8)
    pats = torch.from_numpy(_patterns(toks, sigma,
                                      np.random.default_rng(5)))
    calls = []

    def rank(*args, **kw):
        calls.append(args[1].shape[0])
        return fm_query.rank_packed_plain(*args, **kw)

    want = fm_query.fm_query_packed_plain(index, pats, 16)
    got = fm_query.fm_query_packed_plain(index, pats, 16, rank=rank)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    B = pats.shape[0]
    assert calls.count(B) == 2 * pats.shape[1]              # search
    assert calls.count(B * 16) == index.sa_sample_rate       # walk


def test_wrappers_refuse_bad_cuda_arguments(built):
    """A tensor that is not on the CPU goes to the CUDA argument check,
    which refuses non-int32 and non-contiguous tensors before any launch
    (``meta`` tensors stand in for CUDA ones on a host without a card)."""
    toks, sigma, sa, bwt, row = built["proteins"]
    index = fm.build_fm_index(torch.from_numpy(bwt), row, sigma, 64,
                              sa=torch.from_numpy(sa), sa_sample_rate=8)
    meta64 = torch.empty((4, 8), dtype=torch.int64, device="meta")
    strided = torch.empty((8, 8), dtype=torch.int32, device="meta")[:, ::2]
    meta32 = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="int32"):
        ops.fm_query_unpacked(index, meta64, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fm_query_unpacked(index, strided, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fm_query_unpacked(index, meta32, 16)
    packed = fm.build_fm_index(torch.from_numpy(built["sigma4"][3]),
                               built["sigma4"][4], 4, 32)
    with pytest.raises(TypeError, match="int32"):
        ops.fm_query_packed(packed, meta64)
    with pytest.raises(ValueError, match="no packed layout"):
        ops.fm_query_packed(index, meta32)
    # a search needs no SA sample; a locate does
    with pytest.raises(ValueError, match="SA sample"):
        ops.fm_query_packed(packed, meta32, 4)


def _launch_params(src: str, name: str) -> int:
    """Parameter count of ``extern "C" int <name>_launch(...)`` in src."""
    m = re.search(r'extern "C" int ' + name + r"_launch\(([^)]*)\)", src)
    assert m, f"no C entry {name}_launch"
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("name", _build.KERNELS)
def test_kernel_source_declares_its_signature(name):
    """Every kernel's source exists and its C entry takes as many
    parameters as the ctypes signature passes (file reads only, no
    nvcc)."""
    src = (_build.CSRC / f"{_build.KERNELS[name]}.cu").read_text()
    assert _launch_params(src, name) == len(_build.SIGNATURES[name])
    assert "Replaces:" in src and "Bound on the H100" in src


@pytest.mark.parametrize("entry", sorted(_build.SIGNATURES))
def test_every_c_entry_declares_its_signature(entry):
    """Every ctypes signature, a kernel's own C entry or another entry of
    its library (``merge_walk_kway``), matches exactly one C entry of the
    kernel sources in its parameter count."""
    srcs = [(_build.CSRC / f"{n}.cu").read_text() for n in _build.SOURCES]
    found = [s for s in srcs if f'extern "C" int {entry}_launch(' in s]
    assert len(found) == 1
    assert _launch_params(found[0], entry) == len(_build.SIGNATURES[entry])


def test_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared header renames every kernel's library, so a
    checkout never reuses one built from the old header."""
    for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._target(name) for name in _build.SOURCES}
    header = tmp_path / "rank_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert len(set(after.values())) == len(_build.SOURCES)
