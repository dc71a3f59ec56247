"""Training in a world of ranks against the JAX package's jitted train step
on the same mesh: the six dense attention configs under ``TRAIN_RULES``
on the meshes ``(pod 1, data 2, model 2)`` and ``(2, 2, 2)``
(``test_torch_train_world_ssm.py`` has the SSM and hybrid configs,
``test_torch_train_world_moe.py`` the two MoE configs,
``test_torch_train_world_fsdp.py`` the reference's ``fsdp_v2`` /
``fsdp_v3`` rule sets; this file holds the machinery, each file's JAX
side compiling in a process of its own).

The JAX side runs once per module: this file run as a script with 8 forced
host devices (``--jax-reference OUT``), meshes of Auto axis types.  Per
case it places ``init_model``'s weights by ``model_shardings`` and the
optimizer state leaf for leaf like them, and runs one jitted function:
``jax.value_and_grad(loss_fn)`` and one ``make_train_step`` step, without
and with ``compress_grads``, from moments of a run under way (M0, V0) and
an error buffer of ERR0.  It writes the global arrays, and every leaf's
shard index on every device.

The port runs one gloo CPU world per mesh (``run_world`` with
``mesh_shape``), every rank looping over the cases and reading the
reference from its file: its parameter blocks lie where the JAX shards
do; its gradient (``loss_fn`` by autograd, summed over each leaf's
replicated axes) is the JAX gradient cut at its coordinate within
GRAD_TOL; the loss, ``grad_norm``, ``lr`` and every updated param /
moment / error block within STEP_TOL of 1 + |b|; remat "none" and "dots"
give "full"'s gradient bit for bit.  int8 rounding is discontinuous: an
element whose compressed gradient (the reference's gradient plus ERR0)
lies within TIE of a rounding boundary, in units of the tensor's scale,
may round to the other level, so its error buffer may differ by one
level (the scale) and its param and moments are not compared; such ties
must stay under 4 TIE of the elements (a uniform spread gives 2 TIE).
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

from test_torch_lm_world import DENSE, MESHES, MOE, build, paths
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)
from torch_session_cache import jax_reference_env

SSM = ("mamba2_1p3b", "recurrentgemma_2b")
FSDP_ARCHS = ("qwen2p5_3b", "mamba2_1p3b")
B, S = 4, 8
GRAD_TOL, MOE_GRAD_TOL = 1e-4, 1e-3
STEP_TOL = 1e-5
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=12)
# the state a step starts from: moments of a run under way (with zero
# moments AdamW's first step is g / (|g| + eps), whose rounding noise on a
# near-zero gradient reaches lr itself), an error buffer
M0, V0, ERR0 = 1e-3, 1e-6, 1e-4
TIE = 1e-3        # |g / scale| this close to a rounding boundary may flip
WORLD_TIMEOUT_S = 600

# (mesh size, rule set, config, global batch)
CASES = [(n, "train", a, B) for n in MESHES for a in DENSE if a not in SSM]
SSM_CASES = [(n, "train", a, B) for n in MESHES for a in SSM]
FSDP_CASES = [(n, r, a, B) for n in MESHES
              for r in ("fsdp_v2", "fsdp_v3") for a in FSDP_ARCHS]
# at B = 2 on (2, 2, 2) the rows split over pod alone, so the MoE gathers
# the tokens over pod and cuts each (pod, data) shard's own from them
MOE_CASES = ([(n, "train", a, B) for n in MESHES for a in MOE]
             + [(8, "train", a, 2) for a in MOE])
FAMILIES = {"dense": CASES, "ssm": SSM_CASES, "fsdp": FSDP_CASES,
            "moe": MOE_CASES}


def key(case) -> str:
    n, rules, arch, b = case
    return f"{n}/{rules}/{arch}/B{b}"


def rule_set(name: str, train_rules: dict) -> dict:
    """``TRAIN_RULES`` or the reference's fsdp_v2 / fsdp_v3 variant of them,
    built as ``src/repro/launch/perf.py`` ``qwen_train`` builds them (pure
    data parallel + ZeRO-3; v3 keeps the vocab over model)."""
    if name == "train":
        return dict(train_rules)
    v2 = dict(train_rules, heads=(), kv_heads=(), mlp=(), inner=(),
              act_model=(), vocab=(), batch=("pod", "data", "model"),
              fsdp=("data",))
    return v2 if name == "fsdp_v2" else dict(v2, vocab=("model",))


def batch(cfg, b: int) -> dict:
    """Tokens and labels (b, S) of a config, with some labels padded."""
    rng = np.random.default_rng(cfg.vocab_size + cfg.num_layers)
    toks = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    labels[0, -3:] = labels[-1, :2] = -1         # LABEL_PAD
    return {"tokens": toks, "labels": labels}


# --------------------------------------------------------------------------
# the JAX reference (script mode)
# --------------------------------------------------------------------------

def _jax_case(case, params, mesh):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.models import transformer as jtf
    from repro.sharding import TRAIN_RULES, MeshContext
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jtl
    from test_torch_lm_world import _index

    n, rules, arch, b = case
    cfg = jbase.get_reduced_config(arch)
    ctx = MeshContext(mesh, rule_set(rules, TRAIN_RULES))
    shard = jtf.model_shardings(cfg, ctx)
    placed = jax.device_put(params, shard)

    def fresh(fill):
        return jax.device_put(jax.tree_util.tree_map(
            lambda p: jnp.full(p.shape, fill, jnp.float32), params), shard)

    count = jnp.zeros((), jnp.int32)
    plain = {"params": placed,
             "opt": {"m": fresh(M0), "v": fresh(V0), "count": count}}
    comp = {"params": jax.device_put(params, shard),
            "opt": {"m": fresh(M0), "v": fresh(V0), "count": count},
            "err": fresh(ERR0)}
    data = {k: jnp.asarray(v) for k, v in batch(cfg, b).items()}
    steps = {c: jtl.make_train_step(cfg, ctx, jtl.TrainConfig(
        opt=jopt.AdamWConfig(**ADAMW), compress_grads=c))
        for c in (False, True)}

    def run(params, plain, comp, data):
        loss, grads = jax.value_and_grad(
            lambda p: jtf.loss_fn(p, data, cfg, ctx))(params)
        return (loss, grads, steps[False](plain, data),
                steps[True](comp, data))

    coords = list(np.ndindex(mesh.devices.shape))
    out = {}
    for path, leaf in paths(placed):
        by_dev = {s.device: s for s in leaf.addressable_shards}
        out[f"index/{path}"] = np.stack([
            _index(by_dev[mesh.devices[c]].index, leaf.shape)
            for c in coords])
    loss, grads, (new, metrics), (new_c, metrics_c) = jax.jit(run)(
        placed, plain, comp, data)
    out["loss"] = np.asarray(loss)
    for path, g in paths(grads):
        out[f"grad/{path}"] = np.asarray(g)
    for name, state, m in (("plain", new, metrics), ("comp", new_c,
                                                      metrics_c)):
        for path, leaf in paths(state):
            out[f"{name}/state/{path}"] = np.asarray(leaf)
        for k, v in m.items():
            out[f"{name}/metrics/{k}"] = np.asarray(v)
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


def run_reference(tmp_path_factory, family: str) -> str:
    """The reference's npz for ``family``, written by this file run as a
    script; returns its path (the ranks read it themselves)."""
    out = tmp_path_factory.mktemp(f"jax_train_world_{family}") / "ref.npz"
    env = jax_reference_env(tmp_path_factory)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--jax-reference", str(out), family],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return str(out)


# --------------------------------------------------------------------------
# the port, in a world (each rank)
# --------------------------------------------------------------------------

def _err(got, want) -> float:
    """max |got - want| / (1 + |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
    return float(np.max(np.abs(got - want) / (1 + np.abs(want)),
                        initial=0.0))


def world_rank(mesh, ref_path: str, todo: list) -> dict:
    """Every case of this world's mesh in this rank: its block layout
    against the JAX shards' indices, its gradient blocks, its train steps
    (plain and compressed) against the reference's arrays cut at its
    coordinate; the worst error of each, by leaf."""
    import torch.distributed as dist

    from repro_torch.configs import base
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.sharding import (
        TRAIN_RULES,
        reduce_gradients,
        world_context,
    )
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    torch.set_num_threads(1)
    me = dist.get_rank()
    out = {}
    with np.load(ref_path) as ref:
        for case in todo:
            n, rules, arch, b = case
            if n != mesh.size():
                continue
            k = key(case)
            cfg = base.get_reduced_config(arch)
            ctx = world_context(mesh, rule_set(rules, TRAIN_RULES))
            full = build(tf.model_specs(cfg),
                         lambda path: ref[f"{arch}/params/{path}"])
            shardings = tf.model_shardings(cfg, ctx)
            specs = dict(paths(shardings))
            blocks = {p: ctx.block(specs[p], np.shape(a))
                      for p, a in paths(full)}
            rec = {"index_mismatch": [
                p for p, blk in blocks.items()
                if [(s.start, s.stop) for s in blk]
                != [tuple(r) for r in ref[f"{k}/index/{p}"][me]]],
                "embed_rows": (blocks["embed"][0].start,
                               blocks["embed"][0].stop)}
            params = params_from_numpy(full, "cpu", ctx, shardings)
            data = {name: torch.from_numpy(v)
                    for name, v in batch(cfg, b).items()}

            def cut(name, path):
                return ref[f"{k}/{name}"][blocks[path]]

            grads = {}
            for policy in (("full", "none", "dots") if rules == "train"
                           and n == 4 else ("full",)):
                live = tree_map(lambda t: t.clone().requires_grad_(), params)
                loss = tf.loss_fn(live, data, cfg, ctx, remat_policy=policy)
                g = torch.autograd.grad(loss, tree_leaves(live))
                grads[policy] = reduce_gradients(
                    list(g), ctx, tree_leaves(shardings))
                if policy == "full":
                    rec["loss"] = _err(loss, ref[f"{k}/loss"])
            rec["grad"] = {p: _err(g, cut(f"grad/{p}", p))
                           for (p, _), g in zip(paths(full), grads["full"])}
            rec["remat_equal"] = {
                policy: all(torch.equal(a, b) for a, b in zip(
                    grads["full"], gs)) for policy, gs in grads.items()}
            ties = {}
            for p, _ in paths(full):       # the reference's rounding ties
                g32 = ref[f"{k}/grad/{p}"] + np.float32(ERR0)
                scale = max(float(np.abs(g32).max()) / 127.0, 1e-12)
                frac = np.abs(g32[blocks[p]]) / scale
                ties[p] = (np.abs(frac - np.floor(frac) - 0.5) < TIE, scale)
            rec["ties"] = sum(int(t.sum()) for t, _ in ties.values())
            rec["elements"] = sum(t.size for t, _ in ties.values())
            for name, compress in (("plain", False), ("comp", True)):
                state = {"params": tree_map(torch.clone, params)}
                state["opt"] = init_opt_state(state["params"])
                for part, fill in (("m", M0), ("v", V0)):
                    state["opt"][part] = tree_map(
                        lambda t, f=fill: torch.full_like(t, f), params)
                if compress:
                    state["err"] = tree_map(
                        lambda t: torch.full_like(t, ERR0), params)
                step = make_train_step(cfg, ctx, TrainConfig(
                    opt=AdamWConfig(**ADAMW), compress_grads=compress))
                state, metrics = step(state, data)
                rec[f"{name}/metrics"] = {
                    m: _err(v, ref[f"{k}/{name}/metrics/{m}"])
                    for m, v in metrics.items()}
                rec[f"{name}/count"] = int(state["opt"]["count"])
                leaves = {}
                for part, tree in (("params", state["params"]),
                                   ("opt/m", state["opt"]["m"]),
                                   ("opt/v", state["opt"]["v"]),
                                   ("err", state.get("err"))):
                    if tree is None:
                        continue
                    for (p, _), t in zip(paths(full), tree_leaves(tree)):
                        got = t.detach().numpy()
                        want = cut(f"{name}/state/{part}/{p}", p)
                        tie, scale = ties[p]
                        if compress:
                            if part == "err":    # one level at a tie
                                off = np.abs(got - want)[tie]
                                assert (off <= 1.001 * scale
                                        + STEP_TOL).all(), (k, p)
                            got, want = got[~tie], want[~tie]
                        leaves[f"{part}/{p}"] = _err(got, want)
                rec[f"{name}/state"] = leaves
            out[k] = rec
    return out


def run_worlds(ref_path: str, todo: list) -> dict:
    """{case key: [each rank's record]} from one world per mesh, the
    worlds side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import run_world

    def world(n):
        return run_world(n, world_rank, ref_path, todo,
                         mesh_shape=MESHES[n], timeout_s=WORLD_TIMEOUT_S)

    sizes = sorted({c[0] for c in todo})
    out = {}
    with ThreadPoolExecutor(len(sizes)) as pool:
        for ranks in pool.map(world, sizes):
            for k in ranks[0]:
                out[k] = [r[k] for r in ranks]
    return out


# --------------------------------------------------------------------------
# the checks (shared with test_torch_train_world_moe.py)
# --------------------------------------------------------------------------

def grad_tol(arch: str) -> float:
    return MOE_GRAD_TOL if arch in MOE else GRAD_TOL


def worst(errs: dict) -> tuple:
    name = max(errs, key=errs.get)
    return errs[name], name


def check_layout(world: dict, case) -> None:
    for r, rec in enumerate(world[key(case)]):
        assert rec["index_mismatch"] == [], (r, rec["index_mismatch"])


def check_gradient(world: dict, case) -> None:
    tol = grad_tol(case[2])
    for r, rec in enumerate(world[key(case)]):
        assert rec["loss"] <= STEP_TOL, (r, rec["loss"])
        err, leaf = worst(rec["grad"])
        assert err <= tol, (r, leaf, err)


def check_step(world: dict, case, name: str) -> None:
    for r, rec in enumerate(world[key(case)]):
        assert rec["ties"] <= 4 * TIE * rec["elements"], (r, rec["ties"])
        assert rec[f"{name}/count"] == 1
        err, metric = worst(rec[f"{name}/metrics"])
        assert err <= STEP_TOL, (r, metric, err)
        err, leaf = worst(rec[f"{name}/state"])
        assert err <= STEP_TOL, (r, leaf, err)
        assert any(p.startswith("err/") for p in rec[f"{name}/state"]) == \
            (name == "comp")


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_worlds(run_reference(tmp_path_factory, "dense"), CASES)


@pytest.mark.parametrize("case", CASES, ids=key)
def test_blocks_lie_where_the_jax_shards_do(world, case):
    check_layout(world, case)


@pytest.mark.parametrize("case", CASES, ids=key)
def test_gradient_blocks_match_the_mesh_reference(world, case):
    check_gradient(world, case)


@pytest.mark.parametrize("case", CASES, ids=key)
def test_train_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "plain")


@pytest.mark.parametrize("case", CASES, ids=key)
def test_compressed_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "comp")


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] == 4 and c[1] == "train"], ids=key)
def test_remat_policies_give_equal_gradients_in_a_world(world, case):
    """"full", "dots" and "none" give the same gradient blocks bit for bit
    in a world, as on one device: the recomputed collectives return what
    the forward's did."""
    for rec in world[key(case)]:
        assert rec["remat_equal"] == {"full": True, "none": True,
                                      "dots": True}


if __name__ == "__main__":
    _jax_reference(sys.argv[sys.argv.index("--jax-reference") + 1],
                   sys.argv[-1])
