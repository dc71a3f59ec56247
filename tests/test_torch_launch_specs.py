"""The port's launch specs (``repro_torch/launch/specs.py``) and the dry
run's cell arithmetic against the JAX package's, and the bwt_index
config's ``family`` / ``rounds`` with a mesh build at capped rounds.

The JAX side runs once, as this file run as a script with 512 forced host
devices (``--jax-reference OUT``): the reference's launch modules set
their device count when imported, so no pytest worker imports them.  It
builds abstract values only and compiles nothing: for all ten configs x
four shapes x the two production meshes and the one-device mesh, every
leaf of the batch, the cache, the params and the AdamW state (shape,
dtype, partition spec, ``NamedSharding.shard_shape``), the skip reasons,
``_micro_batches`` at 1, 256 and 512 chips, ``dryrun --list`` for one pod,
one rank's argument bytes of every cell on both production meshes (the
shard shapes' sum, as the reference's dry run lays the arguments out;
for the bwt_index cells from the arguments of ``lower_index_cell``'s own
lowering, each in about 6 s), ``dryrun --list`` for one pod and for both, and the JAX mesh build of a
repetitive text over two devices at capped and default rounds.  The
port's side is computed here and compared exactly.
"""

import json
import os
import subprocess
import sys

if __name__ == "__main__":   # the JAX reference: devices before jax loads
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np
import pytest
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)
from torch_session_cache import jax_reference_env
from torch_session_cache import one_thread  # noqa: F401 (fixture)

MESHES = ("16x16", "2x16x16", "one")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CHIPS = (1, 256, 512)
ROUNDS = (1, None)
# the bwt_index cells' arguments, in the order the reference lowers them
INDEX_ARGS = {"build": ("s",),
              "serve": ("bwt", "occ_samples", "c_array", "fused",
                        "patterns")}


def rounds_tokens() -> np.ndarray:
    """A text of long repeats: a capped round budget leaves groups of
    equal prefixes unsorted."""
    rng = np.random.default_rng(5)
    unit = rng.integers(1, 5, 37).astype(np.int32)
    return np.concatenate([np.tile(unit, 9), rng.integers(1, 5, 61)]
                          ).astype(np.int32)


def _norm_spec(spec) -> list:
    """A partition spec as JSON: per dim None, a name, or a list of
    names (a one-name tuple normalised to its name)."""
    out = []
    for p in spec:
        if isinstance(p, (tuple, list)):
            p = p[0] if len(p) == 1 else list(p)
        out.append(p)
    return out


# --------------------------------------------------------------------------
# the JAX reference (script mode)
# --------------------------------------------------------------------------

def _jax_reference(out_path: str) -> None:
    import contextlib
    import io

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs.base import ARCH_IDS, get_config
    from repro.core.dist_suffix_array import DistSAConfig
    from repro.core.pipeline import build_index
    from repro.launch import dryrun
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import SHAPES as RSHAPES
    from repro.launch.specs import (
        batch_specs,
        cache_specs,
        opt_state_abstract,
        param_specs_abstract,
        shape_skip_reason,
    )
    from repro.sharding import DECODE_RULES, TRAIN_RULES, MeshContext

    meshes = {"16x16": make_production_mesh(multi_pod=False),
              "2x16x16": make_production_mesh(multi_pod=True),
              "one": jax.make_mesh((1, 1, 1), ("pod", "data", "model"))}

    def leaves(tree):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            sh = leaf.sharding
            spec = (_norm_spec(sh.spec) if isinstance(sh, NamedSharding)
                    else [])
            local = (list(sh.shard_shape(leaf.shape))
                     if isinstance(sh, NamedSharding) else list(leaf.shape))
            out[key] = [list(leaf.shape), str(leaf.dtype), spec, local]
        return out

    archs = [a for a in ARCH_IDS if a != "bwt_index"]
    ref = {"cells": {}, "params": {}, "micro": {}, "skip": {}}
    for arch in archs:
        cfg = get_config(arch)
        for mname, mesh in meshes.items():
            for rname, rules in (("train", TRAIN_RULES),
                                 ("decode", DECODE_RULES)):
                ctx = MeshContext(mesh, rules)
                params = param_specs_abstract(cfg, ctx)
                ref["params"][f"{arch}|{mname}|{rname}"] = {
                    "params": leaves(params),
                    "opt_state": leaves(opt_state_abstract(params))}
            ctx = MeshContext(mesh, TRAIN_RULES)
            for shape in SHAPES:
                ref["cells"][f"{arch}|{shape}|{mname}"] = {
                    "batch": leaves(batch_specs(cfg, shape, ctx)),
                    "cache": leaves(cache_specs(cfg, shape, ctx))}
        for shape in SHAPES:
            ref["skip"][f"{arch}|{shape}"] = shape_skip_reason(cfg, shape)
            for chips in CHIPS:
                ref["micro"][f"{arch}|{shape}|{chips}"] = \
                    dryrun._micro_batches(cfg, shape, chips)
    # one rank's argument bytes of each cell on each production mesh, as
    # lower_cell lays the arguments out: the sum of every leaf's
    # NamedSharding.shard_shape x itemsize, by kind
    ref["rank_bytes"] = {}
    for arch in archs:
        cfg = get_config(arch)
        for mname in ("16x16", "2x16x16"):
            for shape in SHAPES:
                kind = RSHAPES[shape]["kind"]
                ctx = MeshContext(meshes[mname], TRAIN_RULES if kind == "train"
                                  else DECODE_RULES)
                params = param_specs_abstract(cfg, ctx, jnp.bfloat16)
                args = {"params": params,
                        "batch": batch_specs(cfg, shape, ctx)}
                if kind == "train":
                    args["opt_state"] = opt_state_abstract(params)
                if kind == "decode":
                    args["cache"] = cache_specs(cfg, shape, ctx)
                ref["rank_bytes"][f"{arch}|{shape}|{mname}"] = {
                    k: sum(int(np.prod(leaves(v)[key][3]))
                           * np.dtype(leaves(v)[key][1]).itemsize
                           for key in leaves(v))
                    for k, v in args.items()}
    # the bwt_index cells: one rank's bytes of each argument that
    # lower_index_cell's lowering takes (lowered, not compiled), by name
    ref["index_bytes"] = {}
    for shape, names in INDEX_ARGS.items():
        for mname, multi_pod in (("16x16", False), ("2x16x16", True)):
            lowered, _, _ = dryrun.lower_index_cell(shape,
                                                    multi_pod=multi_pod)
            avals = [a._aval for a in
                     jax.tree_util.tree_leaves(lowered.args_info)]
            assert len(avals) == len(names), (shape, avals)
            ref["index_bytes"][f"{shape}|{mname}"] = {
                name: int(np.prod(a.sharding.shard_shape(a.shape)))
                * np.dtype(a.dtype).itemsize
                for name, a in zip(names, avals)}
    for key, pods in (("list", "single"), ("list_both", "both")):
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = ["dryrun", "--list", "--multi-pod", pods]
        try:
            with contextlib.redirect_stdout(buf):
                dryrun.main()
        finally:
            sys.argv = argv
        ref[key] = buf.getvalue().splitlines()
    ref["family"] = get_config("bwt_index").family
    toks = rounds_tokens()
    mesh = jax.make_mesh((2,), ("parts",), devices=jax.devices()[:2])
    ref["rounds"] = {}
    for rounds in ROUNDS:
        idx = build_index(toks, mesh, sample_rate=8, sa_sample_rate=4,
                          sa_config=DistSAConfig(engine="samplesort",
                                                 rounds=rounds))
        ref["rounds"][str(rounds)] = {
            "sa": np.asarray(idx.sa).tolist(),
            "bwt": np.asarray(idx.bwt).tolist(), "row": int(idx.row)}
    with open(out_path, "w") as f:
        json.dump(ref, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_launch_specs") / "ref.json"
    env = jax_reference_env(tmp_path_factory)
    proc = subprocess.run([sys.executable, __file__, "--jax-reference",
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# the port
# --------------------------------------------------------------------------

def _port_meshes():
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import single_device_context

    return {"16x16": make_production_mesh(multi_pod=False),
            "2x16x16": make_production_mesh(multi_pod=True),
            "one": dict(single_device_context().mesh)}


def _leaves(abstract) -> dict:
    from repro_torch.launch.specs import _map_with_path

    out = {}

    def visit(path, t):
        spec = _at(abstract.specs, path)
        out["/".join(map(str, path))] = [
            list(t.shape), str(t.dtype).replace("torch.", ""),
            _norm_spec(spec), list(_at(abstract.local, path))]

    _map_with_path(visit, abstract.tree)
    return out


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _archs():
    from repro_torch.configs.base import ARCH_IDS

    return [a for a in ARCH_IDS if a != "bwt_index"]


@pytest.mark.parametrize("arch", _archs())
def test_param_and_opt_specs_equal_the_reference(reference, arch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import (
        opt_state_abstract,
        param_specs_abstract,
    )
    from repro_torch.sharding import DECODE_RULES, TRAIN_RULES, MeshContext

    cfg = get_config(arch)
    for mname, mesh in _port_meshes().items():
        for rname, rules in (("train", TRAIN_RULES),
                             ("decode", DECODE_RULES)):
            ctx = MeshContext(mesh, rules)
            params = param_specs_abstract(cfg, ctx)
            want = reference["params"][f"{arch}|{mname}|{rname}"]
            assert _leaves(params) == want["params"], (mname, rname)
            opt = _leaves(opt_state_abstract(params, ctx))
            assert opt == want["opt_state"], (mname, rname)


@pytest.mark.parametrize("arch", _archs())
def test_batch_and_cache_specs_equal_the_reference(reference, arch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import batch_specs, cache_specs
    from repro_torch.sharding import TRAIN_RULES, MeshContext

    cfg = get_config(arch)
    for mname, mesh in _port_meshes().items():
        ctx = MeshContext(mesh, TRAIN_RULES)
        for shape in SHAPES:
            want = reference["cells"][f"{arch}|{shape}|{mname}"]
            assert _leaves(batch_specs(cfg, shape, ctx)) == want["batch"], (
                mname, shape)
            assert _leaves(cache_specs(cfg, shape, ctx)) == want["cache"], (
                mname, shape)


def test_skip_reasons_and_micro_batches_equal_the_reference(reference):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import _micro_batches
    from repro_torch.launch.specs import shape_skip_reason

    skipped = 0
    for arch in _archs():
        cfg = get_config(arch)
        for shape in SHAPES:
            reason = shape_skip_reason(cfg, shape)
            assert reason == reference["skip"][f"{arch}|{shape}"]
            skipped += reason is not None
            for chips in CHIPS:
                assert _micro_batches(cfg, shape, chips) == \
                    reference["micro"][f"{arch}|{shape}|{chips}"], (
                        arch, shape, chips)
    assert skipped == 8     # every long_500k cell but the two recurrent


def test_dryrun_list_matches_the_reference_on_one_card(reference, capsys):
    """The port lists the reference's (arch, shape) cells in its order,
    each on the one-card mesh."""
    import ast

    from repro_torch.launch import dryrun

    dryrun.main(["--list"])
    got = [ast.literal_eval(line) for line in
           capsys.readouterr().out.splitlines()]
    want = [ast.literal_eval(line) for line in reference["list"]]
    assert [c[:2] for c in got] == [c[:2] for c in want]
    assert {c[2] for c in got} == {"h100x1"}
    assert not any(c[2] for c in want)     # the reference's single pod


def test_rank_argument_bytes_equal_the_reference_on_both_meshes(
        reference, tmp_path):
    """One rank's argument bytes of every cell (all 40, skipped or not)
    on the 16x16 and 2x16x16 meshes equal the reference's sum of
    ``NamedSharding.shard_shape`` x itemsize; ``dryrun --no-compile
    --multi-pod both`` writes them for the 32 cells of each mesh it would
    trace, the reference's skip reason for the 8 others, and the
    bwt_index cells' specs with the reference's bytes of each argument."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import local_nbytes

    for arch in _archs():
        cfg = get_config(arch)
        for mesh in ("16x16", "2x16x16"):
            for shape in SHAPES:
                _, _, args = dryrun.cell_inputs(cfg, shape, mesh=mesh)
                got = {k: local_nbytes(v) for k, v in args.items()}
                assert got == reference["rank_bytes"][
                    f"{arch}|{shape}|{mesh}"], (arch, shape, mesh)
    recs = dryrun.main(["--no-compile", "--multi-pod", "both", "--out",
                        str(tmp_path)])
    lm = [r for r in recs if r["arch"] != "bwt_index"]
    assert len(lm) == 80
    for r in lm:
        key = f"{r['arch']}|{r['shape']}"
        assert r["chips"] == {"16x16": 256, "2x16x16": 512}[r["mesh"]]
        if reference["skip"][key]:
            assert (r["status"], r["reason"]) == ("skipped",
                                                  reference["skip"][key])
        else:
            assert r["status"] == "specs"
            assert r["argument_bytes"] == reference["rank_bytes"][
                f"{key}|{r['mesh']}"]
    index = [r for r in recs if r["arch"] == "bwt_index"]
    assert [(r["shape"], r["mesh"], r["status"]) for r in index] == [
        (s, m, "specs") for s in ("build", "serve")
        for m in ("16x16", "2x16x16")]
    for r in index:
        assert r["argument_bytes"] == reference["index_bytes"][
            f"{r['shape']}|{r['mesh']}"]


def test_index_mesh_cells_traced_at_full_size(reference, tmp_path):
    """``dryrun --arch bwt_index --multi-pod both`` at the config's n =
    2^28: four traced records, each rank's argument bytes the
    reference's, the build's 26 rounds after the q = 6 init over buckets
    of ceil(2 m / P) (8192 on 16x16, 2048 on 2x16x16) counting the radix
    kernels' bytes, the serve cell's 64 psums of int32[1024] counting
    ``rank_select``'s, each fitting one card."""
    from repro_torch.launch import dryrun

    recs = dryrun.main(["--arch", "bwt_index", "--multi-pod", "both",
                        "--out", str(tmp_path)])
    assert [(r["shape"], r["mesh"], r["status"]) for r in recs] == [
        (s, m, "traced") for s in ("build", "serve")
        for m in ("16x16", "2x16x16")]
    for r in recs:
        assert r["argument_bytes"] == reference["index_bytes"][
            f"{r['shape']}|{r['mesh']}"]
        m = (1 << 28) // r["chips"]
        assert r["memory"]["fits"] and r["collectives"]["moved_bytes"] > 0
        kb = r["counts"]["kernel_bytes"]
        if r["shape"] == "build":
            assert r["held_argument_bytes"] == {"s": 4 * m}
            assert (r["rounds_traced"], r["h0"]) == (26, 6)
            assert r["bucket_capacity"] == {256: 8192, 512: 2048}[
                r["chips"]]
            assert kb["radix_hist"] > 0 and kb["radix_pos"] > 0
        else:
            assert r["collectives"]["calls"] == {"psum": 64}
            assert r["collectives"]["bytes"] == {"psum": [64 * 4096] * 2}
            assert kb["rank_select"] > 0


def test_dryrun_list_on_both_meshes_matches_the_reference(reference,
                                                          capsys):
    """``--list --multi-pod both`` prints the reference's (arch, shape,
    multi_pod) cells, in its order."""
    from repro_torch.launch import dryrun

    dryrun.main(["--list", "--multi-pod", "both"])
    assert capsys.readouterr().out.splitlines() == reference["list_both"]


def test_bwt_index_config_family_and_rounds(reference):
    from repro_torch.configs.base import get_config
    from repro_torch.configs.bwt_index import reduced
    from repro_torch.core.pipeline import mesh_sa_config

    cfg = get_config("bwt_index")
    assert cfg.family == reference["family"] == "index"
    assert cfg.rounds is None and reduced().rounds is None
    dist = mesh_sa_config(cfg.replace(rounds=7, engine="bitonic"))
    assert (dist.rounds, dist.engine, dist.capacity_factor) == (
        7, "bitonic", cfg.capacity_factor)


def rounds_rank(mesh) -> dict:
    from repro_torch.configs.bwt_index import CONFIG
    from repro_torch.core import dist_sort
    from repro_torch.core.dist_suffix_array import gather_shards
    from repro_torch.core.pipeline import build_index, mesh_sa_config

    out = {}
    for rounds in ROUNDS:
        dist_sort.reset_collectives()
        cfg = mesh_sa_config(CONFIG.replace(rounds=rounds))
        idx = build_index(rounds_tokens(), mesh, sample_rate=8,
                          sa_sample_rate=4, sa_config=cfg, device="cpu")
        info = dist_sort.shard_info(mesh, idx.length)
        out[str(rounds)] = dict(
            sa=gather_shards(info, idx.sa), bwt=gather_shards(info, idx.bwt),
            row=idx.row, bytes=dict(dist_sort.COLLECTIVE_BYTES),
            calls=dict(dist_sort.COLLECTIVES))
    return out


def test_mesh_build_with_rounds_equals_the_reference(reference):
    """``rounds`` reaches the mesh build (``mesh_sa_config``): at capped
    and default budgets the SA, BWT and row of a world of two equal the
    JAX mesh build's, and each collective records its bytes."""
    from repro_torch.launch.mesh import run_world

    ranks = run_world(2, rounds_rank, timeout_s=120)
    capped_differs = False
    for got in ranks:
        for rounds in ROUNDS:
            want = reference["rounds"][str(rounds)]
            g = got[str(rounds)]
            assert np.array_equal(g["sa"], want["sa"]), rounds
            assert np.array_equal(g["bwt"], want["bwt"]), rounds
            assert int(g["row"]) == want["row"]
            for kind, calls in g["calls"].items():
                assert (g["bytes"][kind][0] > 0) == (calls > 0), kind
        capped_differs |= not np.array_equal(got["1"]["sa"],
                                             got["None"]["sa"])
    # one round leaves the repeats unsorted: the capped SA is another one
    assert capped_differs


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-reference":
        _jax_reference(sys.argv[2])
    else:
        sys.exit(pytest.main([__file__, *sys.argv[1:]]))
