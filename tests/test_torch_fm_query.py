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
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)


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


# -- fm_query_unpacked.cu's launch plan and a model of its groups ---------

RESIDENT = 2112    # blocks of 128 threads an H100 holds at 16 a SM


@pytest.mark.parametrize("B, k, r, resident, aligned, grid, vector", [
    (1024, 16, 64, RESIDENT, True, 1024, True),     # one wave
    (1024, 16, 64, 1000, True, 1000, True),         # strided
    (1024, 0, 64, RESIDENT, True, 64, True),        # count
    (1024, 1, 64, RESIDENT, True, 64, True),        # a row a pattern
    (1024, 64, 128, RESIDENT, True, RESIDENT, True),
    (7, 17, 62, RESIDENT, True, 8, False),          # r % 4 != 0
    (100, 4, 32, RESIDENT, False, 25, False),       # unaligned BWT
    (5, 3, 7, 1, True, 1, False),
    (0, 16, 64, RESIDENT, True, 1, True),
])
def test_unpacked_plan_by_hand(B, k, r, resident, aligned, grid, vector):
    """A block of 128 lanes is 16 groups of 8, a group a unit (a pattern's
    search, or one of its k rows), a block a tile of 16 units and two
    int32 of shared memory a unit; the grid is a block a tile, at most
    one resident wave."""
    plan = fm_query.unpacked_plan(B, k, r, resident, aligned)
    assert plan == {"grid": grid, "vector": vector}
    assert fm_query.UNPACKED_THREADS == 8 * fm_query.UNPACKED_UNITS
    units = B * max(k, 1)
    assert grid * fm_query.UNPACKED_UNITS >= min(
        units, resident * fm_query.UNPACKED_UNITS)


def test_unpacked_source_matches_the_plan():
    """The kernel source has the plan's block and group sizes, its tile of
    shared (sp, ep), and entries taking the argument types the wrapper
    passes."""
    src = (_build.CSRC / "fm_query_unpacked.cu").read_text()
    assert f"THREADS = {fm_query.UNPACKED_THREADS};" in src
    assert "G = 8;" in src and "__shared__ int tile[2 * PER];" in src
    m = re.search(r'extern "C" int fm_query_unpacked_occupancy\(([^)]*)\)',
                  src)
    assert m and len(m.group(1).split(",")) == len(
        fm_query.UNPACKED_OCCUPANCY_ARGTYPES)


def _unpacked_model(index, P, k, plan):
    """fm_query_unpacked.cu's blocks in plain Python: every block's tiles
    (grid-stride) of units (a pattern's search for k = 0, else one of its
    k rows), the tile's searching groups and what the others read of
    them, the chunks a lane of
    a group loads at each rank (only where a chunk's first symbol lies
    below the cut; each symbol below the cut voted once) and the walk's
    steps.  Returns (sp, ep, positions) and how often each slot of them
    was written."""
    G, per, grid = 8, fm_query.UNPACKED_UNITS, plan["grid"]
    r, n, sigma = index.sample_rate, index.length, index.sigma
    vec = r % 4 == 0
    bwt = index.bwt.tolist()
    occ = index.occ_samples.tolist()
    C = index.c_array.tolist()
    pats = P.tolist()
    B, m = P.shape

    def count(blk, c, cut):
        votes = [0] * cut
        total = 0
        for g in range(G):
            for j0 in range(0, cut, 8 * G):
                for j in (j0 + 4 * g, j0 + 4 * (G + g)):
                    if j < cut:                 # the chunk is read
                        assert not vec or j + 3 < r
                        for i in range(j, min(j + 4, cut)):
                            votes[i] += 1
                            total += bwt[blk * r + i] == c
        assert votes == [1] * cut
        return total

    def search(b):
        sp, ep = 0, n
        for c in reversed(pats[b]):
            if 1 <= c < sigma and ep > sp:
                b0, b1 = min(sp // r, len(occ) - 1), min(ep // r, len(occ) - 1)
                sp, ep = (C[c] + occ[b0][c] + count(b0, c, sp - b0 * r),
                          C[c] + occ[b1][c] + count(b1, c, ep - b1 * r))
            elif c != PAD and not 1 <= c < sigma:
                ep = sp
        return sp, ep

    def walk(row):
        for steps in range(index.sa_sample_rate):
            blk, cut = row // r, row % r
            if r <= 8 * G:      # c from the lane that loaded its chunk
                loaded = {i for g in range(G) for j in (4 * g, 4 * (G + g))
                          if j <= cut for i in range(j, min(j + 4, r))}
                assert cut in loaded and (cut // 4) % G < G
            c = bwt[row]
            cnt = count(blk, c, cut)
            marked, val = fm_query.sample_lookup(
                index.sa_marks, index.sa_mark_ranks, index.sa_vals,
                torch.tensor([row], dtype=torch.int32),
                val_bits=index.sa_val_bits, val_scale=index.sa_sample_rate)
            if bool(marked[0]):
                return int(val[0]) + steps
            row = C[c] + occ[blk][c] + cnt
        return 0

    kk = max(k, 1)
    units = B * kk
    sp_out, ep_out = [None] * B, [None] * B
    pos = [[None] * k for _ in range(B)]
    writes = {"sp": [0] * B, "pos": [[0] * k for _ in range(B)]}
    for block in range(grid):
        for u0 in range(block * per, units, grid * per):
            first = u0 // kk
            npat = (min(u0 + per, units) - 1) // kk - first + 1
            tile = [search(first + s) for s in range(min(npat, per))]
            for s, (sp, ep) in enumerate(tile):
                if (first + s) * kk >= u0:
                    sp_out[first + s], ep_out[first + s] = sp, ep
                    writes["sp"][first + s] += 1
            for slot in range(per):
                u = u0 + slot
                if u >= units:
                    continue
                b, j = divmod(u, kk)
                assert 0 <= b - first < npat
                if k:
                    sp, ep = tile[b - first]
                    pos[b][j] = walk(sp + j) if sp + j < ep else n
                    writes["pos"][b][j] += 1
    out = (torch.tensor(sp_out, dtype=torch.int32),
           torch.tensor(ep_out, dtype=torch.int32),
           torch.tensor(pos, dtype=torch.int32).view(B, k))
    return out, writes


@pytest.mark.parametrize("r", [7, 30, 62, 64, 200])
@pytest.mark.parametrize("k", [0, 1, 3, 17])
@pytest.mark.parametrize("resident", [1, 2, 3])
def test_unpacked_model_matches_the_plain_version(built, r, k, resident):
    """The kernel's groups, tiles and shared searches, modelled, give the
    plain version's answers on the english case at sigma 258, each answer
    written once, with one to three blocks striding over the tiles."""
    toks, _, sa, bwt, row = built["english"]
    index = fm.build_fm_index(torch.from_numpy(bwt), row, 258, r,
                              sa=torch.from_numpy(sa), sa_sample_rate=8)
    pats = _patterns(toks, 258, np.random.default_rng(r + k))[::3, :48]
    P = torch.from_numpy(np.ascontiguousarray(pats))
    plan = fm_query.unpacked_plan(P.shape[0], k, r, resident)
    got, writes = _unpacked_model(index, P, k, plan)
    want = fm_query.fm_query_unpacked_plain(index, P, k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert writes["sp"] == [1] * P.shape[0]
    assert writes["pos"] == [[1] * k] * P.shape[0]


@pytest.mark.parametrize("r", [62, 64])
@pytest.mark.parametrize("compress", [False, True])
def test_plain_at_sigma_258_matches_reference_locate(built, no_kernels, r,
                                                     compress):
    """The english index at the bwt_index config's alphabet (258 Occ
    columns), r = 62 (not a multiple of 4: the kernel's 4-byte loads) and
    64, against the JAX package's count and locate up to k = 64."""
    toks, _, sa, bwt, row = built["english"]
    want = jfm.build_fm_index(jnp.asarray(bwt), jnp.asarray(row), 258, r,
                              sa=jnp.asarray(sa), sa_sample_rate=8,
                              compress_sa=compress)
    got = fm.build_fm_index(torch.from_numpy(bwt), row, 258, r,
                            sa=torch.from_numpy(sa), sa_sample_rate=8,
                            compress_sa=compress)
    assert got.bits == 0 and got.occ_samples.shape[1] == 258
    pats = _patterns(toks, 258, np.random.default_rng(r))
    P, jP = torch.from_numpy(pats), jnp.asarray(pats)
    jcount = np.asarray(jfm.count(want, jP))
    assert np.array_equal(fm.count(got, P).numpy(), jcount)
    for k in (1, 15, 16, 17, 64):
        sp, ep, pos = fm_query.fm_query_unpacked_plain(got, P, k)
        jpos, jcnt = jfm.locate(want, jP, k)
        assert np.array_equal(torch.sort(pos, dim=1).values.numpy(),
                              np.asarray(jpos))
        assert np.array_equal((ep - sp).clamp(max=k).numpy(),
                              np.asarray(jcnt))
