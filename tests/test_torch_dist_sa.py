"""The port's distributed suffix array and BWT
(``repro_torch/core/dist_suffix_array.py``) and the mesh branch of
``pipeline.build_index`` against the JAX package.

The suffix array of a text is unique, so the ISA, SA, BWT and row that the
port's ranks build in gloo worlds of 1, 2, 4 and 8 ranks are held against
the JAX package's single-device build of the same prepared text, in this
process.  The knob matrix is the reference's ``scenario_sa_fused``
(``tests/dist_driver.py``): both engines, q-gram init on/off, one or two
init words, discarding on/off, compare or radix local sorts, with the
samplesort capacity overflow retried by doubling as ``build_index`` does
(a unary text overflows by design).  Exact equality throughout.
"""

import numpy as np
import pytest
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)
from torch_session_cache import one_thread  # noqa: F401 (fixture)

AXIS = "parts"
PARTS = (1, 2, 4, 8)
WORLD_TIMEOUT_S = 120
# (sigma_hi, engine, qgram, qgram_words, discard, local_sort): the
# reference's scenario_sa_fused cases
MATRIX = [
    (2, "bitonic", True, 2, True, "compare"),
    (2, "samplesort", True, 2, True, "compare"),   # max skew: all keys ==
    (4, "bitonic", True, 2, True, "radix"),
    (4, "samplesort", True, 2, True, "radix"),
    (4, "samplesort", True, 1, False, "compare"),
    (20, "bitonic", False, 1, True, "compare"),
    (20, "samplesort", True, 2, True, "compare"),
    (64, "bitonic", True, 1, False, "radix"),
    (64, "samplesort", False, 1, True, "compare"),
    (64, "samplesort", True, 2, False, "compare"),
]
# longer texts with the default knobs: several doubling rounds
LONG = [(5, "bitonic", 2000), (5, "samplesort", 2000), (21, "bitonic", 3000),
        (21, "samplesort", 1500)]


def texts(P: int) -> dict:
    """Sentinel-terminated texts of the matrix (n = 24 P, as in
    ``scenario_sa_fused``) and of the long cases, from fixed seeds."""
    rng = np.random.default_rng(13)
    out = {}
    for sigma_hi in sorted({c[0] for c in MATRIX}):
        toks = rng.integers(1, max(2, sigma_hi), 24 * P - 1).astype(np.int32)
        if sigma_hi == 2:
            toks[:] = 1   # unary: maximally repetitive AND skewed
        out[("matrix", sigma_hi)] = np.append(toks, 0).astype(np.int32)
    for sigma_hi, _, n in LONG:
        toks = rng.integers(1, sigma_hi, n).astype(np.int32)
        toks[n // 3: n // 3 + 200] = toks[:200]           # a long repeat
        pad = (-(n + 1)) % (8 * P)
        s = np.concatenate([toks, [0], np.full(pad, sigma_hi, np.int32)])
        out[("long", sigma_hi, n)] = s.astype(np.int32)
    return out


def _sigma(s) -> int:
    return int(s.max()) + 1


def port_rank(mesh, P: int) -> dict:
    """Every case on this rank: ISA/SA/BWT shards, the row, and the
    overflow flag of each attempt."""
    from repro_torch.core.dist_suffix_array import (
        DistSAConfig,
        build_isa_sharded,
        dist_bwt_local,
        isa_overflowed,
        local_text,
    )

    tx = texts(P)
    cases = [(("matrix", c[0]), c[1:]) for c in MATRIX]
    cases += [(("long", sh, n), (eng, True, 2, True, "auto"))
              for sh, eng, n in LONG]
    out = {}
    for key, (engine, qgram, qw, discard, ls) in cases:
        s = tx[key]
        cfg = DistSAConfig(engine=engine, capacity_factor=4.0, qgram=qgram,
                           qgram_words=qw, discard=discard, local_sort=ls)
        flags = []
        for _ in range(4):
            isa = build_isa_sharded(s, mesh, cfg, sigma=_sigma(s),
                                    device="cpu")
            flags.append(isa_overflowed(isa))
            if not flags[-1]:
                break
            cfg = cfg._replace(capacity_factor=cfg.capacity_factor * 2)
        info, s_local = local_text(s, mesh, device="cpu")
        sa, bwt, row = dist_bwt_local(info, cfg, s_local, isa)
        out[(key, engine, qgram, qw, discard, ls)] = dict(
            isa=isa, sa=sa, bwt=bwt, row=row, overflowed=flags)
    return out


@pytest.fixture(scope="module")
def port():
    from repro_torch.launch.mesh import run_world

    return {P: run_world(P, port_rank, P, timeout_s=WORLD_TIMEOUT_S)
            for P in PARTS}


def _jax_build(s):
    """The JAX package's single-device (SA, BWT, row) of ``s``."""
    import jax.numpy as jnp

    from repro.core.bwt import bwt_from_sa
    from repro.core.suffix_array import suffix_array

    sa = suffix_array(jnp.asarray(s), _sigma(s))
    bwt, row = bwt_from_sa(jnp.asarray(s), sa)
    return np.asarray(sa), np.asarray(bwt), int(row)


@pytest.mark.parametrize("P", PARTS)
def test_isa_sa_bwt_row_equal_the_reference(port, P):
    tx = texts(P)
    want = {key: _jax_build(s) for key, s in tx.items()}
    ranks = port[P]
    for case in ranks[0]:
        key = case[0]
        sa_w, bwt_w, row_w = want[key]
        isa = np.concatenate([r[case]["isa"] for r in ranks])
        sa = np.concatenate([r[case]["sa"] for r in ranks])
        assert np.array_equal(sa, sa_w), case
        assert np.array_equal(isa[sa_w], np.arange(len(sa_w))), case
        assert np.array_equal(np.concatenate([r[case]["bwt"] for r in ranks]),
                              bwt_w), case
        assert {int(r[case]["row"]) for r in ranks} == {row_w}, case


@pytest.mark.parametrize("P", PARTS)
def test_overflow_retry_runs_where_the_reference_overflows(port, P):
    """Every rank reports the same overflow flags, the last attempt fits
    and the bitonic engine never overflows.  The unary text's init keys
    are all equal, so each rank sends its whole shard to one bucket: at 8
    parts that exceeds the 4.0 factor's buckets (half a shard) and the
    retry runs."""
    ranks = port[P]
    for case in ranks[0]:
        flags = {tuple(r[case]["overflowed"]) for r in ranks}
        assert len(flags) == 1, case
        (flags,) = flags
        assert flags[-1] is False, case
        if case[1] == "bitonic":
            assert flags == (False,), case
    unary = ((("matrix", 2), "samplesort", True, 2, True, "compare"))
    assert ranks[0][unary]["overflowed"][0] is (P == 8)


# --------------------------------------------------------------------------
# pipeline.build_index(tokens, mesh)
# --------------------------------------------------------------------------

PIPELINE = [("bitonic", 3.0, 3), ("samplesort", 3.0, 3),
            ("samplesort", 0.25, 4)]


def pipeline_tokens() -> np.ndarray:
    return np.random.default_rng(11).integers(1, 6, 777).astype(np.int32)


def pipeline_rank(mesh) -> dict:
    from repro_torch.core.dist_suffix_array import DistSAConfig, gather_shards
    from repro_torch.core.dist_sort import shard_info
    from repro_torch.core.pipeline import SAConfig, build_index

    toks = pipeline_tokens()
    out = {}
    for engine, cf, retries in PIPELINE:
        idx = build_index(
            toks, mesh, sample_rate=8, device="cpu", max_retries=retries,
            sa_config=DistSAConfig(engine=engine, capacity_factor=cf))
        info = shard_info(mesh, idx.length)
        out[(engine, cf)] = dict(sa=gather_shards(info, idx.sa),
                                 bwt=gather_shards(info, idx.bwt),
                                 row=idx.row, sigma=idx.sigma,
                                 length=idx.length,
                                 text_length=idx.text_length)
    # an SAConfig takes the mesh knobs' defaults (the bitonic engine)
    idx = build_index(toks, mesh, sample_rate=8, device="cpu",
                      sa_config=SAConfig(local_sort="radix"))
    out["sa_config"] = gather_shards(shard_info(mesh, idx.length), idx.sa)
    return out


def overflow_rank(mesh):
    from repro_torch.core.dist_suffix_array import DistSAConfig
    from repro_torch.core.pipeline import build_index

    build_index(pipeline_tokens(), mesh, sample_rate=8, device="cpu",
                max_retries=1,
                sa_config=DistSAConfig(engine="samplesort",
                                       capacity_factor=0.25))


@pytest.mark.parametrize("P", (2, 4))
def test_build_index_on_a_mesh_equals_the_reference(P):
    """Both engines, and samplesort from a factor that overflows (the
    retry doubles it until it fits): the JAX package's single-device SA,
    BWT and row of the same prepared text (padded to parts x sample
    rate)."""
    from repro.core.pipeline import prepare_tokens as j_prepare_tokens
    from repro_torch.launch.mesh import run_world

    toks = pipeline_tokens()
    s, sigma = j_prepare_tokens(toks, P * 8)
    sa_w, bwt_w, row_w = _jax_build(s)
    ranks = run_world(P, pipeline_rank, timeout_s=WORLD_TIMEOUT_S)
    for r in ranks:
        for engine, cf, _ in PIPELINE:
            got = r[(engine, cf)]
            assert np.array_equal(got["sa"], sa_w), (engine, cf)
            assert np.array_equal(got["bwt"], bwt_w), (engine, cf)
            assert int(got["row"]) == row_w
            assert (got["sigma"], got["length"], got["text_length"]) == (
                sigma, len(s), len(toks) + 1)
        assert np.array_equal(r["sa_config"], sa_w)


def test_build_index_overflow_past_its_retries_raises():
    from repro_torch.launch.mesh import run_world

    with pytest.raises(RuntimeError, match="samplesort capacity overflow "
                                           "after 1 retries"):
        run_world(4, overflow_rank, timeout_s=WORLD_TIMEOUT_S)
