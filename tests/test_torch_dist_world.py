"""The port's index mesh, its world of local ranks
(``repro_torch/launch/mesh.py``) and the collectives of
``repro_torch/core/dist_sort.py`` on the CPU (gloo): each collective
against numpy (``gather`` only to rank 0), counted once per call; a rank that raises or hangs fails
its world with the rank's traceback and leaves no process behind.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import dist_sort as ds
from repro_torch.launch.mesh import make_index_mesh, run_world
from torch_session_cache import one_thread  # noqa: F401 (fixture)

TIMEOUT_S = 60


def collectives_rank(mesh) -> dict:
    info = ds.shard_info(mesh, 4 * mesh.size())
    me = ds._me(info)
    P = info.parts
    x = torch.arange(4, dtype=torch.int32) + 10 * me
    ds.reset_collectives()
    out = {
        "all_gather": ds.all_gather(info, x),
        "gather": ds.gather(info, x),
        "ppermute": ds.ppermute(info, x, [(i, (i + 1) % P)
                                          for i in range(P)]),
        "all_to_all": ds.all_to_all(info, torch.stack(
            [x + 100 * d for d in range(P)])),
        "psum": ds.psum(info, x),
        "pmax": ds.pmax(info, torch.tensor(me == 1)),
        "x": x,
        "transport": ds.transport(info, "cpu"),
        "dims": mesh.mesh_dim_names,
    }
    out["counts"] = dict(ds.COLLECTIVES)
    return out


@pytest.mark.parametrize("P", [1, 3])
def test_collectives_against_numpy(P):
    ranks = run_world(P, collectives_rank, timeout_s=TIMEOUT_S)
    xs = np.stack([r["x"] for r in ranks])
    for me, r in enumerate(ranks):
        assert np.array_equal(r["all_gather"], xs)
        if me == 0:
            assert np.array_equal(r["gather"], xs)
        else:
            assert r["gather"] is None
        assert np.array_equal(r["ppermute"], xs[(me - 1) % P])
        assert np.array_equal(r["all_to_all"], xs + 100 * me)
        assert np.array_equal(r["psum"], xs.sum(0))
        assert bool(r["pmax"]) == (P > 1) and r["pmax"].dtype == np.bool_
        assert r["transport"] == "gloo, direct"
        assert r["dims"] == ("parts",)
        assert r["counts"] == {"all_gather": 1, "gather": 1, "ppermute": 1,
                               "all_to_all": 1, "psum": 1, "pmax": 1}


def not_a_permutation_rank(mesh):
    info = ds.shard_info(mesh, 2)
    ds.ppermute(info, torch.zeros(1, dtype=torch.int32), [(0, 1), (1, 1)])


def test_ppermute_refuses_a_non_permutation():
    with pytest.raises(RuntimeError, match="needs a permutation of 2 ranks"):
        run_world(2, not_a_permutation_rank, timeout_s=TIMEOUT_S)


def raising_rank(mesh, bad: int):
    info = ds.shard_info(mesh, mesh.size())
    if ds._me(info) == bad:
        raise ValueError(f"rank {bad} gives up")
    # the others wait in a collective the failed rank never joins
    ds.psum(info, torch.ones(1))


def test_a_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_world(3, raising_rank, 1, timeout_s=TIMEOUT_S)
    assert "rank 1 raised" in str(err.value)
    assert "ValueError: rank 1 gives up" in str(err.value)
    assert time.monotonic() - t0 < TIMEOUT_S / 2


def hanging_rank(mesh):
    if mesh.get_local_rank("parts") == 0:
        time.sleep(600)


def test_a_world_past_its_timeout_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within 5"):
        run_world(2, hanging_rank, timeout_s=5)
    assert time.monotonic() - t0 < 30


def test_a_world_needs_a_rank():
    with pytest.raises(ValueError, match="at least one rank"):
        run_world(0, collectives_rank)


def test_mesh_device_types():
    with pytest.raises(ValueError, match="mesh device type"):
        make_index_mesh("tpu")


def test_a_mesh_is_a_device_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        ds.mesh_parts(object())


# --------------------------------------------------------------------------
# the LM world's collectives and layout helpers (sharding.py)
# --------------------------------------------------------------------------

LM_MESH = {"pod": 1, "data": 2, "model": 2}


def lm_collectives_rank(mesh) -> dict:
    from repro_torch.sharding import all_gather, psum, world_context

    ctx = world_context(mesh)
    me = torch.distributed.get_rank()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7 + me
    xb = (torch.arange(4, dtype=torch.float32) * 0.375 + me).to(
        torch.bfloat16)
    ds.reset_collectives()
    out = {
        "x": x,
        "coords": [ctx.coordinate((a,)) for a in ("pod", "data", "model")],
        "psum_model": psum(x, ctx),
        "psum_all": psum(x, ctx, ("pod", "data", "model")),
        "gather_model_1": all_gather(x, ctx, ("model",), 1),
        "gather_batch_0": all_gather(x, ctx, ("pod", "data"), 0),
        "psum_bf16": psum(xb, ctx).float(),
        "psum_bf16_dtype": str(psum(xb, ctx).dtype),
        "gather_bf16": all_gather(xb, ctx, ("data",), 0).float(),
    }
    out["counts"] = dict(ds.COLLECTIVES)
    return out


def test_lm_collectives_against_numpy():
    """psum and tiled all_gather over the axes of a (1, 2, 2) mesh, float32
    and bfloat16 (gloo reduces bfloat16 itself: the dtype is kept)."""
    ranks = run_world(4, lm_collectives_rank, timeout_s=TIMEOUT_S,
                      mesh_shape=LM_MESH)
    xs = np.stack([r["x"] for r in ranks])
    for me, r in enumerate(ranks):
        data, model = divmod(me, 2)          # rank r at row-major coordinate
        assert r["coords"] == [0, data, model]
        pair = xs[[2 * data, 2 * data + 1]]  # this rank's model group
        np.testing.assert_allclose(r["psum_model"], pair.sum(0), rtol=1e-6)
        np.testing.assert_allclose(r["psum_all"], xs.sum(0), rtol=1e-6)
        assert np.array_equal(r["gather_model_1"], np.concatenate(pair, 1))
        col = xs[[model, 2 + model]]         # this rank's data group
        assert np.array_equal(r["gather_batch_0"], np.concatenate(col, 0))
        xb = np.arange(4) * 0.375
        assert r["psum_bf16_dtype"] == "torch.bfloat16"
        # 0.375 k + data-group sums are exact in bfloat16 here
        assert np.array_equal(r["psum_bf16"], 2 * xb + 4 * data + 1)
        assert np.array_equal(r["gather_bf16"],
                              np.concatenate([xb + model, xb + 2 + model]))
        # an axis of size 1 (pod) takes no collective
        assert r["counts"]["psum"] == 1 + 2 + 2 and \
            r["counts"]["all_gather"] == 1 + 1 + 1


def lm_argmax_rank(mesh) -> dict:
    from repro_torch.sharding import global_argmax, world_context

    ctx = world_context(mesh)
    # global logits (B 4, V 8): row 0 ties across the two vocab blocks,
    # row 1 within one block, row 2 has one maximum, row 3 is all equal
    g = torch.zeros(4, 8)
    g[0, 2] = g[0, 6] = 5.0
    g[1, 5] = g[1, 7] = 3.0
    g[2, 4] = 9.0
    return {"ids": global_argmax(ctx.local_block(g, ("data", "model")), ctx,
                                 ("batch", "act_model"), (4, 8)),
            "want": torch.argmax(g, dim=-1)}


def test_global_argmax_ties_to_the_lower_id():
    """Greedy over vocab blocks: the largest value, ties to the lower
    global id (as jnp.argmax of the whole array), on every rank."""
    for r in run_world(4, lm_argmax_rank, timeout_s=TIMEOUT_S,
                       mesh_shape=LM_MESH):
        assert r["ids"].tolist() == [2, 5, 4, 0]
        assert np.array_equal(r["ids"], r["want"])


def lm_constrain_rank(mesh) -> dict:
    from repro_torch.sharding import constrain, world_context

    ctx = world_context(mesh)
    good = torch.zeros(2, 3, 4)        # (4, 3, 8) over (data, -, model)
    constrain(good, ctx, ("batch", None, "act_model"), (4, 3, 8))
    try:
        constrain(torch.zeros(4, 3, 4), ctx, ("batch", None, "act_model"),
                  (4, 3, 8))
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": ""}


def test_constrain_raises_on_a_wrong_block():
    for r in run_world(4, lm_constrain_rank, timeout_s=TIMEOUT_S,
                       mesh_shape=LM_MESH):
        assert "gives (2, 3, 4)" in r["raised"]


def test_a_mesh_of_the_wrong_size_is_refused():
    with pytest.raises(RuntimeError, match="needs 4 ranks, the world has 2"):
        run_world(2, lm_constrain_rank, timeout_s=TIMEOUT_S,
                  mesh_shape=LM_MESH)


# --------------------------------------------------------------------------
# the collectives' backward: each one's transpose (sharding.py)
# --------------------------------------------------------------------------

# (name, the global array's layout, what each rank computes from its
# block): psum over model, over the batch axes; tiled all_gather over
# model on dim 1, over the batch axes on dim 0; gather_spec of every dim
GRAD_SPEC = ("data", "model")
GRAD_CASES = ("psum_model", "psum_batch", "gather_model", "gather_batch",
              "gather_spec")


def _collective(name, x, ctx):
    from repro_torch.sharding import all_gather, gather_spec, psum

    return {"psum_model": lambda: psum(x, ctx),
            "psum_batch": lambda: psum(x, ctx, ("pod", "data")),
            "gather_model": lambda: all_gather(x, ctx, ("model",), 1),
            "gather_batch": lambda: all_gather(x, ctx, ("pod", "data"), 0),
            "gather_spec": lambda: gather_spec(x, ctx, GRAD_SPEC)}[name]()


def lm_backward_rank(mesh) -> dict:
    """Per case: the gradient of sum_r <f_r(block of X), W_r> over the
    world with respect to this rank's block of X (its share, then summed
    over the axes the block is replicated over), and the same function of
    the global X through autograd in this process, cut to the block."""
    from repro_torch import sharding
    from repro_torch.sharding import reduce_gradients, world_context

    ctx = world_context(mesh)
    me = torch.distributed.get_rank()
    X = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 6)).astype(np.float32))
    block = ctx.block(GRAD_SPEC, X.shape)
    out = {}
    for name in GRAD_CASES:
        def weight(rank, shape):
            return torch.from_numpy(np.random.default_rng(
                [GRAD_CASES.index(name), rank]).normal(size=shape).astype(
                    np.float32))

        x = X[block].clone().requires_grad_()
        y = _collective(name, x, ctx)
        (g,) = torch.autograd.grad(torch.sum(y * weight(me, y.shape)), x)
        (g,) = reduce_gradients([g], ctx, [GRAD_SPEC])
        # the global function: every rank's output from the global X;
        # rank q sits at (data, model) = divmod(q, 2) and holds block q
        Xg = X.clone().requires_grad_()
        parts = [Xg[2 * d:2 * d + 2, 3 * m:3 * m + 3]
                 for d, m in map(lambda q: divmod(q, 2), range(ctx.size))]
        total = 0
        for r in range(ctx.size):
            data_r, model_r = divmod(r, 2)
            same_data = parts[2 * data_r:2 * data_r + 2]
            same_model = parts[model_r::2]
            yr = {"psum_model": lambda: sum(same_data),
                  "psum_batch": lambda: sum(same_model),
                  "gather_model": lambda: torch.cat(same_data, 1),
                  "gather_batch": lambda: torch.cat(same_model, 0),
                  "gather_spec": lambda: Xg}[name]()
            total = total + torch.sum(yr * weight(r, yr.shape))
        (want,) = torch.autograd.grad(total, Xg)
        out[name] = {"got": g, "want": want[block], "y_graph":
                     y.grad_fn is not None}
    sharding.reset_traffic()
    with torch.no_grad():
        y = _collective("psum_model", X[block].clone().requires_grad_(), ctx)
        out["no_grad_graph"] = y.grad_fn is not None
    out["traffic"] = dict(sharding.TRAFFIC)
    return out


@pytest.fixture(scope="module")
def backward_world():
    return run_world(4, lm_backward_rank, timeout_s=TIMEOUT_S,
                     mesh_shape=LM_MESH)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_collective_backward_is_its_transpose(backward_world, name):
    """In a world of 4 (1, 2, 2): the gradient of every rank's output
    weighted by its own W_r, taken through the collective on each rank's
    block and summed over the axes the block is replicated over, equals
    autograd of the same function on the global tensor, cut to the
    rank's block (psum's backward a psum, a tiled all_gather's a
    reduce-scatter, gather_spec's their chain)."""
    for r in backward_world:
        assert r[name]["y_graph"]
        np.testing.assert_allclose(r[name]["got"], r[name]["want"],
                                   rtol=1e-6, atol=1e-6)


def test_collectives_record_no_graph_with_grad_off(backward_world):
    """With grad mode off a collective is the plain call: no graph, one
    forward call counted by kind and pass."""
    for r in backward_world:
        assert not r["no_grad_graph"]
        assert r["traffic"] == {"psum/forward": [1, 2 * 3 * 4]}
