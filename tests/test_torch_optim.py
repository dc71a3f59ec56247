"""The port's optimizer and gradient compression against the JAX
package's: the warmup-cosine schedule, ``global_norm``, ``adamw_update``
on trees of 1-D, 2-D and 3-D leaves (float32 and bfloat16 params, clipping
on and off, several steps), int8 ``compress_leaf`` bit for bit, and the
reference's own optimizer and compression unit tests
(``tests/test_models.py`` ``TestOptimizer`` / ``TestCompression``) run on
the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro_torch.models.common import tree_leaves
from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

CFG = dict(lr=1e-2, warmup_steps=3, total_steps=20, min_lr_ratio=0.1)
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are a few hundred KB, and
    torch's thread pool only adds synchronisation, which turns into
    seconds a step when the host's cores are shared with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"norm": a(8), "w": a(8, 6), "stack": [a(3, 5, 4), a(2)],
            "bias": a(6)}


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def _host(t):
    return t.detach().float().numpy()


def test_schedule_matches_reference():
    cfg, jcfg = opt.AdamWConfig(**CFG), jopt.AdamWConfig(**CFG)
    steps = np.arange(CFG["total_steps"] + 6, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.schedule(jcfg, s))(steps))
    got = np.array([float(opt.schedule(cfg, torch.tensor(int(s))))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0 and got[CFG["warmup_steps"]] == np.float32(CFG["lr"])
    assert got[-1] == np.float32(CFG["lr"] * CFG["min_lr_ratio"])
    # no warmup at all: the reference's max(warmup, 1) divides
    zero = dict(lr=0.5, warmup_steps=0, total_steps=4)
    got = [float(opt.schedule(opt.AdamWConfig(**zero), torch.tensor(s)))
           for s in range(6)]
    want = [float(jopt.schedule(jopt.AdamWConfig(**zero), jnp.int32(s)))
            for s in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_matches_reference():
    tree = _tree(0)
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = opt.global_norm(_to_torch(tree))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    bf = opt.global_norm(_to_torch(tree, torch.bfloat16))
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, clip):
    """Four steps from zero moments: params, m, v, count, grad_norm and lr.
    With ``clip`` the gradients are 100x over clip_norm.  float32 within
    1e-6 of ``1 + |x|``; bfloat16 params within one bf16 ulp (a float32
    result one ulp apart may round to the other neighbour)."""
    kw = dict(CFG, clip_norm=1.0 if clip else 1e6)
    cfg, jcfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    tdt = getattr(torch, dtype)
    params = _to_torch(_tree(1), tdt)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, getattr(jnp, dtype)), _tree(1))
    state, jstate = opt.init_opt_state(params), jopt.init_opt_state(jparams)
    assert all(t.dtype == torch.float32
               for t in tree_leaves(state["m"]) + tree_leaves(state["v"]))
    for step in range(STEPS):
        grads = _tree(10 + step, scale=100.0 if clip else 0.1)
        jparams, jstate, jm = jopt.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams,
            jcfg)
        got_p, got_s, m = opt.adamw_update(_to_torch(grads), state, params,
                                           cfg)
        assert got_p is params and got_s is state            # in place
        assert int(state["count"]) == int(jstate["count"]) == step + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    for p, w in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        assert p.dtype == tdt
        w = np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_host(p), w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(_host(p), w, rtol=2.0 ** -7, atol=0)
    for key in ("m", "v"):
        for a, w in zip(tree_leaves(state[key]),
                        jax.tree_util.tree_leaves(jstate[key])):
            np.testing.assert_allclose(_host(a), np.asarray(w), rtol=1e-5,
                                       atol=1e-9)


def test_weight_decay_only_on_matrices():
    """A zero gradient moves only leaves of ndim >= 2 (decay), by
    lr * weight_decay * p."""
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                          weight_decay=0.5, min_lr_ratio=1.0)
    params = _to_torch(_tree(2))
    before = [t.clone() for t in tree_leaves(params)]
    zeros = _to_torch(jax.tree_util.tree_map(np.zeros_like, _tree(2)))
    opt.adamw_update(zeros, opt.init_opt_state(params), params, cfg)
    for p, b in zip(tree_leaves(params), before):
        want = b - 0.1 * 0.5 * b if b.ndim >= 2 else b
        torch.testing.assert_close(p, want, rtol=1e-6, atol=1e-7)


def _compress_inputs():
    """10^4 values whose scale is exactly 1 (max |x| = 127), so x / scale
    hits exact .5 ties (both signs, even and odd neighbours), plus zeros
    and an error buffer that moves some of them."""
    rng = np.random.default_rng(0)
    g = (rng.normal(size=10_000) * 40).astype(np.float32)
    g[:200] = np.arange(-100, 100, dtype=np.float32) + 0.5    # ties
    g[200:400] = 0.0
    g[400] = 127.0
    g = np.clip(g, -127, 127)
    err = np.zeros_like(g)
    err[1000:2000] = (rng.normal(size=1000) * 0.3).astype(np.float32)
    return g, err


def test_compress_leaf_is_the_reference_bit_for_bit():
    g, err = _compress_inputs()
    want_hat, want_err = jax.jit(jcomp.compress_leaf)(jnp.asarray(g),
                                                       jnp.asarray(err))
    got_hat, got_err = comp.compress_leaf(torch.from_numpy(g),
                                          torch.from_numpy(err))
    assert np.array_equal(got_hat.numpy().view(np.uint32),
                          np.asarray(want_hat).view(np.uint32))
    assert np.array_equal(got_err.numpy().view(np.uint32),
                          np.asarray(want_err).view(np.uint32))
    q, scale = comp._quantize(torch.from_numpy(g))
    jq, jscale = jcomp._quantize(jnp.asarray(g))
    assert float(scale) == float(jscale) == 1.0
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert q[:200].tolist() == [int(np.round(v)) for v in g[:200]]  # to even
    # a leaf of all zeros: the 1e-12 floor of the scale, zeros out
    z, zerr = comp.compress_leaf(torch.zeros(5), torch.zeros(5))
    assert not z.any() and not zerr.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_grads_match_reference(dtype):
    grads = _tree(3, scale=0.01)
    err = _tree(4, scale=1e-4)
    jdt = getattr(jnp, dtype)
    want_hat, want_err = jcomp.compressed_grads(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), grads),
        jax.tree_util.tree_map(jnp.asarray, err))
    got_hat, got_err = comp.compressed_grads(
        _to_torch(grads, getattr(torch, dtype)), _to_torch(err))
    for a, w in zip(tree_leaves(got_hat), jax.tree_util.tree_leaves(want_hat)):
        assert a.dtype == getattr(torch, dtype)
        assert np.array_equal(_host(a), np.asarray(w, np.float32))
    for a, w in zip(tree_leaves(got_err), jax.tree_util.tree_leaves(want_err)):
        assert a.dtype == torch.float32
        assert np.array_equal(_host(a), np.asarray(w))
    assert [t.dtype for t in tree_leaves(comp.init_error_state(
        _to_torch(grads, torch.bfloat16)))] == [torch.float32] * 5


# the reference's unit tests (tests/test_models.py:143-190), on the port

def test_adamw_reduces_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                          weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip():
    cfg = opt.AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0,
                          total_steps=10)
    params = {"w": torch.zeros(4)}
    state = opt.init_opt_state(params)
    _, _, metrics = opt.adamw_update({"w": torch.full((4,), 1e6)}, state,
                                     params, cfg)
    assert float(metrics["grad_norm"]) > 1e6  # reported pre-clip


def test_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=256).astype(np.float32))}
    err = comp.init_error_state(g)
    acc = np.zeros(256)
    for _ in range(50):
        g_hat, err = comp.compressed_grads(g, err)
        acc += g_hat["w"].numpy()
    # time-averaged compressed gradient converges to the true gradient
    np.testing.assert_allclose(acc / 50, g["w"].numpy(), atol=0.02)


def test_toy_convergence_with_compression():
    w = torch.tensor([4.0, -2.0, 1.0])
    err = comp.init_error_state({"w": w})
    lr = 0.05
    for _ in range(200):
        g = {"w": 2 * w}
        g_hat, err = comp.compressed_grads(g, err)
        w = w - lr * g_hat["w"]
    assert float(w.abs().max()) < 0.05
