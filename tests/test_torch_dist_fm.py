"""The port's distributed FM index (``repro_torch/core/dist_fm.py``):
every ``DistFMIndex`` field, ``dist_count`` and ``dist_locate`` against
the JAX package's on a mesh, packed (2- and 4-bit) and unpacked, raw and
bit-packed SA samples; ``build_index(tokens, mesh)`` against the JAX
package's mesh build (a samplesort that starts from a factor that
overflows, so both retry); a JAX-built distributed index carried into the
port's ranks (``core/convert.py``) and queried there.

The JAX side runs once per module: this file run as a script with forced
host devices (``--jax-reference OUT``).  Its SA and BWT come from the JAX
package's suffix-array oracle (the suffix array of a text is unique) and
its ``build_dist_fm_index`` shards them over meshes of 1, 2, 4 and 8
devices.
The port builds in gloo worlds of as many ranks through
``build_index(tokens, mesh)`` and gathers its shards back.  Exact
equality throughout.
"""

import os
import subprocess
import sys

if __name__ == "__main__":   # the JAX reference: devices before jax loads
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np
import pytest
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)
from torch_session_cache import jax_reference_env
from torch_session_cache import one_thread  # noqa: F401 (fixture)

AXIS = "parts"
PARTS = (1, 2, 4, 8)
WORLD_TIMEOUT_S = 120
LOCATE_K = 32
# name: (sigma_hi, sample_rate, sa_sample_rate, pack, compress_sa)
LAYOUTS = {
    "dna4": (5, 8, 8, None, None),        # 4-bit packed, packed SA values
    "dna4_raw": (5, 16, 4, None, False),  # 4-bit packed, raw SA values
    "two_bit": (3, 16, 8, None, None),    # 2-bit packed
    "unpacked": (17, 4, 4, False, True),  # sigma > 16 (pack=False too)
}
DIST_FIELDS = ("bwt", "occ_samples", "c_array", "row", "fused", "sa_marks",
               "sa_mark_ranks", "sa_vals")
DIST_AUX = ("sample_rate", "sigma", "length", "parts", "bits",
            "sa_sample_rate", "sa_val_bits")
PIPELINE = dict(engine="samplesort", capacity_factor=0.25)   # overflows
PIPELINE_PARTS = 4


def corpus(name: str, P: int):
    """(tokens, patterns int32[12, 6] PAD-padded) of a layout on P parts:
    substrings of the text, one out-of-alphabet symbol and one empty
    pattern among them."""
    sigma_hi = LAYOUTS[name][0] if name in LAYOUTS else 5
    rng = np.random.default_rng([P, sigma_hi, len(name)])
    toks = rng.integers(1, sigma_hi, 64 * P + 5).astype(np.int32)
    pats = np.full((12, 6), -1, np.int32)
    for b in range(11):
        L = int(rng.integers(1, 7))
        st = int(rng.integers(0, len(toks) - L))
        pats[b, :L] = toks[st: st + L]
    pats[3, 0] = 99
    return toks, pats


def _answers(count, locate, pats) -> dict:
    pos, cnt = locate(pats, LOCATE_K)
    return {"count": np.asarray(count(pats)), "pos": np.asarray(pos),
            "cnt": np.asarray(cnt)}


# --------------------------------------------------------------------------
# the JAX reference (script mode)
# --------------------------------------------------------------------------

def _jax_reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.core.dist_fm import build_dist_fm_index, dist_count, dist_locate
    from repro.core.dist_suffix_array import DistSAConfig
    from repro.core.pipeline import build_index, prepare_tokens
    from repro.core.suffix_array import suffix_array_naive

    saved = {}

    def keep(prefix, fm, answers):
        for f in DIST_FIELDS:
            if getattr(fm, f) is not None:
                saved[f"{prefix}/{f}"] = np.asarray(getattr(fm, f))
        for f in DIST_AUX:
            saved[f"{prefix}/{f}"] = np.asarray(getattr(fm, f))
        for k, v in answers.items():
            saved[f"{prefix}/ans/{k}"] = v

    for P in PARTS:
        mesh = jax.make_mesh((P,), (AXIS,), devices=jax.devices()[:P])
        for name, (_, r, srate, pack, compress) in LAYOUTS.items():
            toks, pats = corpus(name, P)
            s, sigma = prepare_tokens(toks, P * r)
            sa = suffix_array_naive(s).astype(np.int32)
            bwt, row = s[(sa - 1) % len(s)], int(np.argmin(sa))
            fm = build_dist_fm_index(jnp.asarray(bwt), row, mesh, sigma=sigma,
                                     sample_rate=r, sa=jnp.asarray(sa),
                                     sa_sample_rate=srate, pack=pack,
                                     compress_sa=compress)
            keep(f"{P}/{name}", fm, _answers(
                lambda p: dist_count(fm, jnp.asarray(p), mesh),
                lambda p, k: dist_locate(fm, jnp.asarray(p), k, mesh),
                pats))
    P = PIPELINE_PARTS
    mesh = jax.make_mesh((P,), (AXIS,), devices=jax.devices()[:P])
    toks, pats = corpus("pipeline", P)
    idx = build_index(toks, mesh, sample_rate=8, sa_sample_rate=4,
                      sa_config=DistSAConfig(**PIPELINE), max_retries=4)
    keep("pipeline", idx.fm, _answers(idx.count, idx.locate, pats))
    np.savez(out_path, **saved)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dist_fm") / "ref.npz"
    env = jax_reference_env(tmp_path_factory)
    proc = subprocess.run([sys.executable, __file__, "--jax-reference",
                           str(out)], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _fields(ref: dict, prefix: str) -> tuple[dict, dict]:
    arrays = {f: ref.get(f"{prefix}/{f}") for f in DIST_FIELDS}
    aux = {f: int(ref[f"{prefix}/{f}"]) for f in DIST_AUX}
    return arrays, aux


# --------------------------------------------------------------------------
# the port
# --------------------------------------------------------------------------

def port_rank(mesh, P: int, carried: dict, root: str) -> dict:
    """Every layout built through ``build_index(tokens, mesh)``: its
    fields gathered (``convert.to_numpy``) and its answers; the carried
    JAX indexes queried; the last build saved under ``root`` (its
    manifest's kind)."""
    import torch

    from repro_torch.core.convert import dist_fm_index_from_arrays, to_numpy
    from repro_torch.core.dist_fm import dist_count, dist_locate
    from repro_torch.core.dist_suffix_array import DistSAConfig
    from repro_torch.core.index_io import describe_index, save_index
    from repro_torch.core.pipeline import build_index

    def answers(count, locate, pats):
        pats = torch.as_tensor(pats)
        return _answers(count, locate, pats)

    out = {}
    for name, (_, r, srate, pack, compress) in LAYOUTS.items():
        toks, pats = corpus(name, P)
        idx = build_index(toks, mesh, sample_rate=r, sa_sample_rate=srate,
                          pack=pack, compress_sa=compress, device="cpu")
        arrays, aux = to_numpy(idx.fm, mesh)
        out[name] = dict(arrays=arrays, aux=aux,
                         ans=answers(idx.count, idx.locate, pats),
                         text_length=idx.text_length)
        fm = dist_fm_index_from_arrays(*carried[name], mesh, "cpu")
        out[name]["carried"] = answers(
            lambda p, fm=fm: dist_count(fm, p, mesh),
            lambda p, k, fm=fm: dist_locate(fm, p, k, mesh), pats)
        out[name]["carried_back"] = to_numpy(fm, mesh)[0]
    if P == PIPELINE_PARTS:
        toks, pats = corpus("pipeline", P)
        idx = build_index(toks, mesh, sample_rate=8, sa_sample_rate=4,
                          device="cpu", max_retries=4,
                          sa_config=DistSAConfig(**PIPELINE))
        arrays, aux = to_numpy(idx.fm, mesh)
        out["pipeline"] = dict(arrays=arrays, aux=aux,
                               ans=answers(idx.count, idx.locate, pats))
    save_index(root, idx)
    out["saved"] = describe_index(root).kind
    return out


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    from repro_torch.launch.mesh import run_world

    out = {}
    for P in PARTS:
        carried = {name: _fields(reference, f"{P}/{name}")
                   for name in LAYOUTS}
        root = str(tmp_path_factory.mktemp(f"saved_{P}"))
        out[P] = run_world(P, port_rank, P, carried, root,
                           timeout_s=WORLD_TIMEOUT_S)
    return out


def _same_fields(arrays: dict, aux: dict, ref: dict, prefix: str) -> None:
    for f in DIST_FIELDS:
        want = ref.get(f"{prefix}/{f}")
        got = arrays[f]
        assert (got is None) == (want is None), (prefix, f)
        if want is not None:
            assert np.array_equal(got, want), (prefix, f)
    for f in DIST_AUX:
        assert aux[f] == int(ref[f"{prefix}/{f}"]), (prefix, f)


def _same_answers(got: dict, ref: dict, prefix: str) -> None:
    for k, v in got.items():
        assert np.array_equal(v, ref[f"{prefix}/ans/{k}"]), (prefix, k)


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fields_and_answers_equal_the_reference(reference, port, P, layout):
    prefix = f"{P}/{layout}"
    bits = int(reference[f"{prefix}/bits"])
    assert bits == {"dna4": 4, "dna4_raw": 4, "two_bit": 2}.get(layout, 0)
    for r in port[P]:
        got = r[layout]
        _same_fields(got["arrays"], got["aux"], reference, prefix)
        _same_answers(got["ans"], reference, prefix)
        assert got["text_length"] == len(corpus(layout, P)[0]) + 1


@pytest.mark.parametrize("P", PARTS)
def test_a_jax_built_index_answers_in_the_port(reference, port, P):
    """Each rank slices its shard of the JAX index's global arrays, answers
    as the JAX index does, and gathers back the same arrays."""
    for layout in LAYOUTS:
        prefix = f"{P}/{layout}"
        arrays, _ = _fields(reference, prefix)
        for r in port[P]:
            _same_answers(r[layout]["carried"], reference, prefix)
            back = r[layout]["carried_back"]
            for f in DIST_FIELDS:
                assert (back[f] is None) == (arrays[f] is None)
                if arrays[f] is not None:
                    assert np.array_equal(back[f], arrays[f]), (prefix, f)


def test_build_index_on_a_mesh_equals_the_jax_mesh_build(reference, port):
    """Both packages' ``build_index(tokens, mesh)`` from a samplesort
    factor that overflows: the same index and answers after the retries
    (the JAX run's SA is the single-device one)."""
    for r in port[PIPELINE_PARTS]:
        got = r["pipeline"]
        _same_fields(got["arrays"], got["aux"], reference, "pipeline")
        _same_answers(got["ans"], reference, "pipeline")


@pytest.mark.parametrize("P", PARTS)
def test_saving_a_distributed_index_is_not_ported(port, P):
    """Kept by name from before the distributed save was ported: every
    rank's ``save_index`` of a mesh index now writes a ``"dist_fm"``
    checkpoint (its files and restores: ``test_torch_dist_io.py``)."""
    for r in port[P]:
        assert r["saved"] == "dist_fm"


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "src"))
        _jax_reference(sys.argv[2])
