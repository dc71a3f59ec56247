"""The port's distributed primitives (``repro_torch/core/dist_sort.py``)
against the JAX package's ``core/dist_sort.py`` on a mesh, shard by shard.

The JAX side runs once per module: this file run as a script in a
subprocess with forced host devices (``--jax-reference OUT``), every
scenario on meshes of 1, 2, 4, 8 and 6 devices, the outputs saved as
numpy.  The port runs the same scenarios in gloo worlds of as many ranks
(``repro_torch.launch.mesh.run_world``), each rank on its shard.  Every
output is an integer, so the tolerance is exact equality: the sorted
shards, samplesort's whole receive buffers (pad slots included), its
overflow flag and valid counts, the shifted and scattered shards and the
scans.  The bitonic engine needs power-of-two parts: 6 runs samplesort,
the scatter through it, the shift and the scans.
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
PARTS = (1, 2, 4, 8, 6)
POW2 = (1, 2, 4, 8)
WORLD_TIMEOUT_S = 120


def cases(P: int) -> dict:
    """Scenario inputs on ``P`` parts, from fixed seeds: name ->
    (kind, params, arrays).  Key words are uint32 (the port stores their
    bit patterns as int32)."""
    rng = np.random.default_rng(1000 + P)
    out = {}

    def u32(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)

    if P in POW2:
        for i, m in enumerate((5, 37)):
            n = P * m
            k1 = u32(0, 1 << 32, n)
            k1[::3] = k1[1]                               # ties across keys
            out[f"bitonic{i}"] = ("bitonic", dict(engine="compare", kb=None),
                                  (k1, u32(0, 6, n),
                                   np.arange(n, dtype=np.int32)))
        n = P * 64
        out["bitonic_radix"] = ("bitonic", dict(engine="radix", kb=(32, 4)),
                                (u32(0, 1 << 32, n), u32(0, 16, n),
                                 np.arange(n, dtype=np.int32)))
        perm = rng.permutation(n).astype(np.int32)
        out["scatter_bitonic"] = ("scatter_bitonic", {},
                                  (perm, rng.integers(-9, 1000, n)
                                   .astype(np.int32)))
    m = 16
    n = P * m
    x = rng.integers(-50, 100, n).astype(np.int32)
    # q = h // m: 0, 1 with and without a remainder, more, all ranks away
    out["shift"] = ("shift", dict(hs=sorted({1, 3, m - 1, m, m + 1,
                                             2 * m + 3, n - 1, n, n + 5})),
                    (x,))
    out["scan"] = ("scan", {}, (rng.integers(0, 50, (P, 3)).astype(np.int32),
                                rng.integers(-5, 50, P).astype(np.int32)))
    for i, m in enumerate((8, 29)):
        n = P * m
        k2 = u32(0, 8, n)
        k2[::5] = 0xFFFFFFFF                      # real keys equal to the pad
        for cf in (4.0, 0.5):                     # fits / overflows
            out[f"samplesort{i}_cf{cf}"] = (
                "samplesort", dict(cf=cf, engine="compare", kb=None,
                                   pads=None),
                (u32(0, 8, n), k2, np.arange(n, dtype=np.int32), None))
    # the discarding doubling round's call: a valid prefix per shard, the
    # rest set to a field-limited pad, radix local sorts over 20-bit keys
    m = 24
    n = P * m
    nv = rng.integers(0, m + 1, P).astype(np.int32)
    nv[0] = m
    keys = u32(0, 1 << 12, n)
    pad = (1 << 20) - 1
    for r in range(P):
        keys[r * m + nv[r]: (r + 1) * m] = pad
    out["samplesort_valid"] = (
        "samplesort", dict(cf=2.0, engine="radix", kb=(20,), pads=(pad,)),
        (keys, np.arange(n, dtype=np.int32), None, nv))
    perm = rng.permutation(n).astype(np.int32)
    valid = (rng.random(n) < 0.8).astype(np.int32)
    for cf in (4.0, 0.25):
        out[f"scatter_samplesort_cf{cf}"] = (
            "scatter_samplesort", dict(cf=cf),
            (perm, rng.integers(0, 1000, n).astype(np.int32), valid))
    return out


# --------------------------------------------------------------------------
# the JAX reference (script mode)
# --------------------------------------------------------------------------

def _jax_reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from repro.compat import shard_map
    from repro.core import dist_sort as ds

    saved = {}
    for P in PARTS:
        mesh = jax.make_mesh((P,), (AXIS,), devices=jax.devices()[:P])

        def call(fn, *arrays, outs):
            specs = tuple(PS(AXIS) for _ in arrays)
            res = jax.jit(shard_map(fn, mesh=mesh, in_specs=specs,
                                    out_specs=(PS(AXIS),) * outs))(
                *(jnp.asarray(a) for a in arrays))
            return [np.asarray(r) for r in res]

        for name, (kind, prm, arrays) in cases(P).items():
            m = arrays[0].shape[0] // P
            info = ds.ShardInfo(AXIS, P, m)
            if kind == "bitonic":
                got = call(lambda a, b, c: ds.bitonic_sort_sharded(
                    info, (a, b, c), num_keys=2, local_sort=prm["engine"],
                    key_bits=prm["kb"]), *arrays, outs=3)
            elif kind == "scatter_bitonic":
                got = call(lambda i, v: ds.scatter_to_index_bitonic(
                    info, i, (v,)), *arrays, outs=1)
            elif kind == "shift":
                got = call(lambda a, prm=prm: tuple(
                    ds.shift_sharded(info, a, h, -1) for h in prm["hs"]),
                    *arrays, outs=len(prm["hs"]))
            elif kind == "scan":
                info = ds.ShardInfo(AXIS, P, 1)
                got = call(lambda v, s: (
                    ds.exclusive_scan_sharded(info, v[0])[None],
                    ds.exclusive_max_sharded(info, s[0])[None]),
                    *arrays, outs=2)
            elif kind == "samplesort":
                ops = [a for a in arrays[:-1] if a is not None]
                nk = len(ops) - 1
                nv = arrays[-1]

                def ss(*xs, nk=nk, prm=prm, has_nv=nv is not None):
                    res = ds.samplesort_sharded(
                        info, xs[:nk + 1], num_keys=nk,
                        capacity_factor=prm["cf"], key_pads=prm["pads"],
                        n_valid_in=xs[-1][0] if has_nv else None,
                        local_sort=prm["engine"], key_bits=prm["kb"])
                    return (*res.operands, res.n_valid[None],
                            res.overflow[None])

                got = call(ss, *ops, *([] if nv is None else [nv]),
                           outs=nk + 3)
            elif kind == "scatter_samplesort":
                def sc(i, v, ok, prm=prm):
                    (o,), ovf = ds.scatter_to_index_samplesort(
                        info, i, (v,), valid=ok.astype(bool),
                        capacity_factor=prm["cf"])
                    return o, ovf[None]

                got = call(sc, *arrays, outs=2)
            for j, g in enumerate(got):
                if g.dtype == np.uint32:
                    g = g.view(np.int32)
                saved[f"{P}/{name}/{j}"] = g.astype(np.int32)
    np.savez(out_path, **saved)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX reference subprocess, started before the port's worlds so
    that the two overlap."""
    out = tmp_path_factory.mktemp("jax_dist_sort") / "ref.npz"
    env = jax_reference_env(tmp_path_factory)
    proc = subprocess.Popen([sys.executable, __file__, "--jax-reference",
                             str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(jax_run, port):
    """The JAX package's outputs of every scenario, from one subprocess."""
    proc, out = jax_run
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------
# the port, one gloo world per part count
# --------------------------------------------------------------------------

def port_rank(mesh, P: int) -> dict:
    """Every scenario of ``cases(P)`` on this rank's shards: name -> list
    of output shards (scalars as length-1 arrays)."""
    import torch

    from repro_torch.core import dist_sort as ds

    me = mesh.get_local_rank(AXIS)

    def local(a, m):
        return torch.as_tensor(np.ascontiguousarray(
            a.view(np.int32)[me * m: (me + 1) * m]))

    out = {}
    for name, (kind, prm, arrays) in cases(P).items():
        n = arrays[0].shape[0]
        m = n // P
        info = ds.shard_info(mesh, n)
        if kind == "bitonic":
            got = ds.bitonic_sort_sharded(
                info, [local(a, m) for a in arrays], 2,
                local_sort=prm["engine"], key_bits=prm["kb"])
        elif kind == "scatter_bitonic":
            i, v = (local(a, m) for a in arrays)
            got = ds.scatter_to_index_bitonic(info, i, (v,))
        elif kind == "shift":
            got = [ds.shift_sharded(info, local(arrays[0], m), h, -1)
                   for h in prm["hs"]]
        elif kind == "scan":
            info = ds.shard_info(mesh, P)
            v, s = (torch.as_tensor(a[me]) for a in arrays)
            got = [ds.exclusive_scan_sharded(info, v).reshape(1, -1),
                   ds.exclusive_max_sharded(info, s).reshape(1)]
        elif kind == "samplesort":
            ops = [local(a, m) for a in arrays[:-1] if a is not None]
            nv = arrays[-1]
            res = ds.samplesort_sharded(
                info, ops, num_keys=len(ops) - 1, capacity_factor=prm["cf"],
                key_pads=prm["pads"],
                n_valid_in=None if nv is None else torch.tensor(nv[me]),
                local_sort=prm["engine"], key_bits=prm["kb"])
            got = [*res.operands, res.n_valid.reshape(1),
                   res.overflow.reshape(1).to(torch.int32)]
        elif kind == "scatter_samplesort":
            i, v, ok = (local(a, m) for a in arrays)
            (o,), ovf = ds.scatter_to_index_samplesort(
                info, i, (v,), valid=ok.bool(), capacity_factor=prm["cf"])
            got = [o, ovf.reshape(1).to(torch.int32)]
        out[name] = [g.to(torch.int32) for g in got]
    return out


@pytest.fixture(scope="module")
def port():
    from repro_torch.launch.mesh import run_world

    return {P: run_world(P, port_rank, P, timeout_s=WORLD_TIMEOUT_S)
            for P in PARTS}


@pytest.mark.parametrize("P", PARTS)
def test_primitives_equal_the_reference_shard_by_shard(reference, port, P):
    names = list(cases(P))
    checked = 0
    for name in names:
        ranks = port[P]
        for j in range(len(ranks[0][name])):
            got = np.concatenate([r[name][j] for r in ranks])
            want = reference[f"{P}/{name}/{j}"]
            assert got.shape == want.shape, (P, name, j)
            assert np.array_equal(got, want), (P, name, j, got, want)
            checked += 1
    assert checked >= len(names)


@pytest.mark.parametrize("P", PARTS)
def test_samplesort_overflow_is_flagged_everywhere(reference, P):
    """Half a shard per bucket overflows (the flag comes back from every
    rank); four shards per bucket never do."""
    for i in (0, 1):
        assert not reference[f"{P}/samplesort{i}_cf4.0/4"].any()
        assert reference[f"{P}/samplesort{i}_cf0.5/4"].all()


def _bitonic_rank(mesh):
    import torch

    from repro_torch.core import dist_sort as ds

    info = ds.shard_info(mesh, 12)
    x = torch.arange(2, dtype=torch.int32)
    ds.bitonic_sort_sharded(info, (x, x))


def test_bitonic_needs_power_of_two_parts():
    from repro_torch.launch.mesh import run_world

    with pytest.raises(RuntimeError, match="power-of-two parts, got 6"):
        run_world(6, _bitonic_rank, timeout_s=WORLD_TIMEOUT_S)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "src"))
        _jax_reference(sys.argv[2])
