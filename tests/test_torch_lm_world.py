"""The LM in a world of ranks (``sharding.world_context``) against the JAX
package on the same mesh: the eight dense / SSM / hybrid reduced configs
(``test_torch_lm_world_moe.py`` has the two MoE configs) under
``TRAIN_RULES`` and ``DECODE_RULES``, on the meshes ``(pod 1, data 2,
model 2)`` and ``(2, 2, 2)``.

The JAX side runs once per module: this file run as a script with 8 forced
host devices (``--jax-reference OUT``), its meshes of Auto axis types.  It
writes each config's params (``init_model`` from one key), and per mesh,
rule set and config: every leaf's shard index on every device (its mesh
coordinate read from ``mesh.devices``), the shard data of a few leaves of
each family, ``forward`` logits at B = 4, S = 8, and ``generate`` (4 prompt
+ 8 new tokens) with the logits its decode step gave at each new token.

The port runs one gloo CPU world per mesh (``run_world`` with
``mesh_shape``), every rank looping over the cases: its parameter blocks
(``params_from_numpy`` with the reference's weights) are bit-equal to the
JAX shard at its coordinate, its blocks of the ``forward`` logits and of
the ``decode_step`` logits (teacher-forced along the reference's tokens)
lie within TOL of the same cut of the reference's, and ``generate`` gives
every rank the same tokens, equal to the reference's except from a step
whose top-2 logits lie within TIE_TOL.  Cases at B = 3 under data = 2
replicate the batch (the spec's fallback); recurrentgemma_2b's single kv
head is replicated over model while its four q heads are split.
"""

import os
import subprocess
import sys

if __name__ == "__main__":   # the JAX reference: devices before jax loads
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np
import pytest
import torch

DENSE = ["qwen2p5_3b", "minitron_4b", "nemotron_4_15b", "llava_next_34b",
         "musicgen_medium", "minicpm3_4b", "mamba2_1p3b",
         "recurrentgemma_2b"]
MOE = ["deepseek_v2_236b", "llama4_maverick_400b_a17b"]
MESHES = {4: {"pod": 1, "data": 2, "model": 2},
          8: {"pod": 2, "data": 2, "model": 2}}
RULES = ("train", "decode")
B, S, PROMPT, NEW = 4, 8, 4, 8
TOL = 1e-4            # float32: |a - b| <= TOL * (1 + |b|)
MOE_TOL = 1e-3        # as test_torch_models.py holds the MoE configs
TIE_TOL = 1e-4
WORLD_TIMEOUT_S = 600
# leaves whose JAX shards are written whole (every leaf's index is): a
# few of each family
SHARD_LEAVES = {"wq", "wk", "wo", "kv_down", "k_up", "q_up", "router",
                "w_gate", "w_down", "in_proj", "conv_w", "A_log", "w_a",
                "out"}


def cases(archs, *, batch3=()):
    """(mesh size, rules, arch, batch) of a family: every config on both
    meshes under both rule sets, and ``batch3`` at B = 3 on (1, 2, 2)."""
    out = [(n, r, a, B) for n in MESHES for r in RULES for a in archs]
    return out + [(4, r, a, 3) for r in RULES for a in batch3]


CASES = cases(DENSE, batch3=("qwen2p5_3b", "mamba2_1p3b",
                             "recurrentgemma_2b"))
MOE_CASES = cases(MOE, batch3=MOE)
FAMILIES = {"dense": CASES, "moe": MOE_CASES}


def key(case) -> str:
    n, rules, arch, b = case
    return f"{n}/{rules}/{arch}/B{b}"


def tokens(cfg, b: int) -> np.ndarray:
    return np.random.default_rng(b).integers(0, cfg.vocab_size,
                                             (b, S)).astype(np.int32)


def paths(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def build(tree, get, prefix=""):
    """``tree``'s structure with each leaf ``get(path)``."""
    if isinstance(tree, dict):
        return {k: build(v, get, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [build(v, get, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return get(prefix[:-1])


# --------------------------------------------------------------------------
# the JAX reference (script mode)
# --------------------------------------------------------------------------

def _index(idx, shape) -> np.ndarray:
    """A shard's index as (start, stop) per dim."""
    return np.array([s.indices(n)[:2] for s, n in zip(idx, shape)],
                    np.int64).reshape(len(shape), 2)


def _jax_case(case, params, mesh):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.models import transformer as jtf
    from repro.serving import engine as jengine
    from repro.sharding import DECODE_RULES, TRAIN_RULES, MeshContext

    n, rules, arch, b = case
    cfg = jbase.get_reduced_config(arch)
    ctx = MeshContext(mesh, TRAIN_RULES if rules == "train"
                      else DECODE_RULES)
    placed = jax.device_put(params, jtf.model_shardings(cfg, ctx))
    out = {}
    coords = list(np.ndindex(mesh.devices.shape))
    for path, leaf in paths(placed):
        by_dev = {s.device: s for s in leaf.addressable_shards}
        shards = [by_dev[mesh.devices[c]] for c in coords]
        out[f"index/{path}"] = np.stack([_index(s.index, leaf.shape)
                                         for s in shards])
        if path.rsplit("/", 1)[-1] in SHARD_LEAVES:
            out[f"shard/{path}"] = np.stack([np.asarray(s.data)
                                             for s in shards])
    toks = tokens(cfg, b)
    fwd = jax.jit(lambda p, t: jtf.forward(p, {"tokens": t}, cfg, ctx))
    out["forward"] = np.asarray(fwd(placed, jnp.asarray(toks)))
    seen = []

    def greedy(logits):
        seen.append(np.asarray(logits))
        return jnp.argmax(logits, axis=-1)

    try:
        res = jengine.generate(placed, cfg, ctx, toks[:, :PROMPT], NEW,
                               sample=greedy)
    except Exception as e:   # the shard_map's own refusal of a batch
        out["decode_error"] = np.array(f"{type(e).__name__}: {e}")
    else:
        out["tokens"] = res.tokens
        out["decode"] = np.stack(seen)
    return out


def _jax_reference(out_path: str, family: str) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import base as jbase
    from repro.models import transformer as jtf

    todo = FAMILIES[family]
    saved, params = {}, {}
    for arch in sorted({c[2] for c in todo}):
        cfg = jbase.get_reduced_config(arch)
        params[arch] = jax.jit(lambda k: jtf.init_model(cfg, k, jnp.float32))(
            jax.random.key(0))
        for path, leaf in paths(params[arch]):
            saved[f"{arch}/params/{path}"] = np.asarray(leaf)
    meshes = {n: jax.make_mesh(tuple(axes.values()), tuple(axes),
                               axis_types=(AxisType.Auto,) * 3,
                               devices=jax.devices()[:n])
              for n, axes in MESHES.items()}
    # the cases compile independently: eight at a time
    with ThreadPoolExecutor(8) as pool:
        futures = {key(c): pool.submit(_jax_case, c, params[c[2]],
                                       meshes[c[0]]) for c in todo}
        for k, fut in futures.items():
            for name, v in fut.result().items():
                saved[f"{k}/{name}"] = v
    np.savez(out_path, **saved)


def run_reference(tmp_path_factory, family: str) -> dict:
    out = tmp_path_factory.mktemp(f"jax_lm_world_{family}") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--jax-reference", str(out), family],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------
# the port, in a world (each rank)
# --------------------------------------------------------------------------

def world_rank(mesh, ref: dict, todo: list) -> dict:
    """Every case of this world's mesh in this rank: param blocks against
    the JAX shards at its coordinate, its blocks of forward and decode
    logits (with their slices), generate's tokens."""
    import torch.distributed as dist

    from repro_torch.configs import base
    from repro_torch.core import dist_sort as ds
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serving.engine import generate
    from repro_torch.sharding import (
        DECODE_RULES,
        TRAIN_RULES,
        world_context,
    )

    me = dist.get_rank()
    out = {}
    for case in todo:
        n, rules, arch, b = case
        if n != mesh.size():
            continue
        k = key(case)
        cfg = base.get_reduced_config(arch)
        ctx = world_context(mesh, TRAIN_RULES if rules == "train"
                            else DECODE_RULES)
        full = build(tf.model_specs(cfg),
                     lambda path: ref[f"{arch}/params/{path}"])
        shardings = tf.model_shardings(cfg, ctx)
        params = params_from_numpy(full, "cpu", ctx, shardings)
        rec = {"mismatch": [], "index_mismatch": []}
        specs = dict(paths(shardings))
        for (path, t), (_, a) in zip(paths(params), paths(full)):
            want = ref[f"{k}/index/{path}"][me]
            got = ctx.block(specs[path], a.shape)
            if [(s.start, s.stop) for s in got] != [tuple(r) for r in want]:
                rec["index_mismatch"].append(path)
            cut = a[tuple(slice(*r) for r in want)]
            shard = ref.get(f"{k}/shard/{path}")
            if not (np.array_equal(t.numpy(), cut) and (
                    shard is None or np.array_equal(t.numpy(), shard[me]))):
                rec["mismatch"].append(path)
        toks = torch.from_numpy(tokens(cfg, b))
        V = cfg.vocab_size
        spec3 = ctx.spec_for(("batch", None, "act_model"), (b, S, V))
        rec["forward"] = tf.forward(params, {"tokens": toks}, cfg, ctx)
        rec["forward_block"] = [(s.start, s.stop)
                                for s in ctx.block(spec3, (b, S, V))]
        if f"{k}/tokens" not in ref:
            try:
                generate(params, cfg, ctx, toks[:, :PROMPT].numpy(), NEW)
            except ValueError as e:
                rec["decode_error"] = str(e)
            out[k] = rec
            continue
        want = ref[f"{k}/tokens"]
        total = PROMPT + NEW
        cache = tf.init_cache(cfg, b, total, torch.float32, "cpu", ctx)
        dec = []
        for pos in range(total - 1):
            logits, cache = tf.decode_step(
                params, cache, torch.from_numpy(want[:, pos:pos + 1]), pos,
                cfg, ctx)
            if pos >= PROMPT - 1:
                dec.append(logits)
        rec["decode"] = torch.stack(dec)
        spec2 = ctx.spec_for(("batch", "act_model"), (b, V))
        rec["decode_block"] = [(s.start, s.stop)
                               for s in ctx.block(spec2, (b, V))]
        ds.reset_collectives()
        res = generate(params, cfg, ctx, toks[:, :PROMPT].numpy(), NEW)
        rec["tokens"] = res.tokens
        rec["collectives"] = dict(ds.COLLECTIVES)
        out[k] = rec
    return out


def run_worlds(ref: dict, todo: list) -> dict:
    """{case key: [each rank's record]} from one world per mesh, the
    worlds side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import run_world

    def world(n):
        mine = {k: v for k, v in ref.items()
                if "/params/" in k or k.startswith(f"{n}/")}
        return run_world(n, world_rank, mine, todo, mesh_shape=MESHES[n],
                         timeout_s=WORLD_TIMEOUT_S)

    sizes = sorted({c[0] for c in todo})
    out = {}
    with ThreadPoolExecutor(len(sizes)) as pool:
        for n, ranks in zip(sizes, list(pool.map(world, sizes))):
            for k in ranks[0]:
                out[k] = [r[k] for r in ranks]
    return out


# --------------------------------------------------------------------------
# the checks (shared with test_torch_lm_world_moe.py)
# --------------------------------------------------------------------------

def tol_of(arch: str) -> float:
    return MOE_TOL if arch in MOE else TOL


def close(got, want, tol: float, what: str) -> None:
    err = np.abs(got - want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert (err <= tol * (1 + np.abs(want))).all(), (what, err.max())


def check_params(world: dict, case) -> None:
    for r, rec in enumerate(world[key(case)]):
        assert rec["index_mismatch"] == [], (r, rec["index_mismatch"])
        assert rec["mismatch"] == [], (r, rec["mismatch"])


def check_forward(world: dict, ref: dict, case) -> None:
    k = key(case)
    want = ref[f"{k}/forward"]
    for r, rec in enumerate(world[k]):
        cut = tuple(slice(*s) for s in rec["forward_block"])
        close(rec["forward"], want[cut], tol_of(case[2]), (k, r))


def check_decode(world: dict, ref: dict, case) -> None:
    k = key(case)
    want = ref[f"{k}/decode"]
    for r, rec in enumerate(world[k]):
        cut = (slice(None),) + tuple(slice(*s) for s in rec["decode_block"])
        close(rec["decode"], want[cut], tol_of(case[2]), (k, r))


def gathered_decode(world: dict, case) -> np.ndarray:
    """The port's decode logits (steps, B, V) put together from the
    ranks' blocks."""
    recs = world[key(case)]
    V = max(rec["decode_block"][1][1] for rec in recs)
    full = np.full((NEW, case[3], V), np.nan, np.float32)
    for rec in recs:
        (r0, r1), (v0, v1) = rec["decode_block"]
        full[:, r0:r1, v0:v1] = rec["decode"]
    assert not np.isnan(full).any()
    return full


def check_tokens(world: dict, ref: dict, case) -> None:
    """Every rank the same tokens; equal to the reference's, or each row
    first differs where the port's own top-2 logits (along the reference's
    tokens) lie within TIE_TOL."""
    k = key(case)
    want = ref[f"{k}/tokens"]
    got = world[k][0]["tokens"]
    for rec in world[k]:
        assert np.array_equal(rec["tokens"], got)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got[:, :PROMPT], want[:, :PROMPT])
    if np.array_equal(got, want):
        return
    logits = gathered_decode(world, case)
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if len(diff):
            top2 = np.sort(logits[diff[0] - PROMPT, row])[-2:]
            assert top2[1] - top2[0] <= TIE_TOL, (k, row, diff[0], top2)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "dense")


@pytest.fixture(scope="module")
def world(reference):
    return run_worlds(reference, CASES)


@pytest.mark.parametrize("case", CASES, ids=key)
def test_param_blocks_are_the_jax_shards(world, case):
    check_params(world, case)


@pytest.mark.parametrize("case", CASES, ids=key)
def test_forward_logits_match_the_mesh_reference(world, reference, case):
    check_forward(world, reference, case)


@pytest.mark.parametrize("case", CASES, ids=key)
def test_decode_logits_match_the_mesh_reference(world, reference, case):
    check_decode(world, reference, case)


@pytest.mark.parametrize("case", CASES, ids=key)
def test_generate_tokens_match_the_mesh_reference(world, reference, case):
    check_tokens(world, reference, case)


def test_a_batch_of_three_is_replicated_over_data(world):
    """B = 3 under data = 2: no batch axis divides it, so every rank holds
    all three rows (and its heads' share)."""
    for case in CASES:
        if case[3] == 3:
            for rec in world[key(case)]:
                assert rec["forward"].shape[0] == 3
                assert rec["forward_block"][0] == (0, 3)


def test_a_single_kv_head_is_replicated_over_model(world, reference):
    """recurrentgemma_2b: kv heads 1, q heads 4 over model = 2, so each
    rank keeps the whole kv head beside its two q heads."""
    k = key((4, "decode", "recurrentgemma_2b", B))
    path = "blocks/s2/mixer/wk"
    idx = reference[f"{k}/index/{path}"]
    assert (idx[:, 2] == [0, 1]).all()                   # the kv head dim
    assert sorted(map(tuple, reference[f"{k}/index/blocks/s2/mixer/wq"][
        :, 2])) == [(0, 2), (0, 2), (2, 4), (2, 4)]
    assert world[k][0]["mismatch"] == []


def test_the_world_gathers_only_under_train_rules(world):
    """ZeRO-3 gathers of the fsdp dims run under TRAIN_RULES only; decode
    rules leave the dense weights resident (the lora ranks of MLA still
    gather over data)."""
    for arch in ("qwen2p5_3b", "mamba2_1p3b"):
        train = world[key((4, "train", arch, B))][0]["collectives"]
        dec = world[key((4, "decode", arch, B))][0]["collectives"]
        assert train["all_gather"] > dec["all_gather"] > 0
        assert train["psum"] == dec["psum"] > 0


if __name__ == "__main__":
    _jax_reference(sys.argv[sys.argv.index("--jax-reference") + 1],
                   sys.argv[-1])
