"""The port's training path against the JAX package's on the same weights
and batch: ``loss_fn``'s gradient (autograd) against ``jax.value_and_grad``
for every reduced config, the ops on the gradient path that need care
(the MoE capacity dispatch, tied routing, the SSD segment sums, the loss's
max shift), the remat policies, and one ``make_train_step`` against the
reference's with and without int8 gradient compression.

Weights come from the port's seeded ``init_model`` and cross as numpy
(``models/convert.py``); the batch is the port's ``TokenLoader`` (batch
for batch the reference's).  The reference runs under a one-device mesh
with Auto axis types, as in ``test_torch_models.py`` (ROADMAP C).
Tolerances: float32 on the CPU, |port - jax| <= TOL * (1 + |jax|).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jbase
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.sharding import MeshContext as JMeshContext
from repro.sharding import TRAIN_RULES as J_TRAIN_RULES
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import base
from repro_torch.data.corpus import corpus
from repro_torch.data.loader import LoaderConfig, TokenLoader
from repro_torch.models import blocks, common, ssm
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.sharding import single_device_context
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop as tl

LM_ARCHS = [a for a in base.ARCH_IDS if a != "bwt_index"]
MOE_ARCHS = ("deepseek_v2_236b", "llama4_maverick_400b_a17b")
GRAD_TOL, MOE_GRAD_TOL = 1e-4, 1e-3
STEP_TOL = 1e-5
B, S = 2, 16
# the optimizer of test_checkpoint.py's bitwise-resume scenario
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=12)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are a few hundred KB, and
    torch's thread pool only adds synchronisation, which turns into
    seconds a step when the host's cores are shared with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_context():
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    return JMeshContext(mesh, J_TRAIN_RULES)


def _weights(arch):
    cfg = base.get_reduced_config(arch)
    return params_to_numpy(tf.init_model(
        cfg, torch.Generator().manual_seed(0), torch.float32, "cpu"))


def _batch(cfg):
    toks = corpus("english", 1 << 12) % (cfg.vocab_size - 1) + 1
    return TokenLoader(toks, LoaderConfig(B, S, seed=3)).batch(0)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def reference():
    """Per arch, once: (weights, batch, the reference's loss and gradient
    as numpy)."""
    ctx = jax_context()
    out = {}

    def get(arch):
        if arch not in out:
            cfg = jbase.get_reduced_config(arch)
            weights, batch = _weights(arch), _batch(cfg)
            grad = jax.jit(jax.value_and_grad(
                lambda p, b: jtf.loss_fn(p, b, cfg, ctx)))
            loss, g = grad(jax.tree_util.tree_map(jnp.asarray, weights),
                           {k: jnp.asarray(v) for k, v in batch.items()})
            out[arch] = (weights, batch, float(loss),
                         jax.tree_util.tree_map(np.asarray, g))
        return out[arch]

    return get


def _port_grad(cfg, weights, batch, remat_policy="full"):
    live = common.tree_map(lambda t: t.requires_grad_(),
                           params_from_numpy(weights, "cpu"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tf.loss_fn(live, tbatch, cfg, single_device_context(),
                      remat_policy=remat_policy)
    leaves = common.tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_gradient_matches_reference(arch, reference):
    weights, batch, want_loss, want = reference(arch)
    cfg = base.get_reduced_config(arch)
    tol = MOE_GRAD_TOL if arch in MOE_ARCHS else GRAD_TOL
    loss, grads = _port_grad(cfg, weights, batch)
    _close(float(loss), want_loss, GRAD_TOL, "loss")
    want_leaves = _leaves(want)
    assert len(grads) == len(want_leaves)
    for g, (path, w) in zip(grads, want_leaves):
        assert tuple(g.shape) == w.shape, path
        _close(g.numpy(), w, tol, jax.tree_util.keystr(path))


class _CountBmm(TorchDispatchMode):
    """Counts ``bmm`` calls by batch: 1 (a weight product, as
    ``torch.einsum`` makes it) or more (attention)."""

    def __init__(self):
        super().__init__()
        self.calls = {"weights": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.calls["weights" if args[0].shape[0] == 1 else "batched"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_policies_give_equal_gradients(arch, reference):
    """"full", "dots" and "none" give the same gradients bit for bit, and
    each policy acts: the backward of "full" recomputes the groups'
    weight products and attention, "dots" only the batched products."""
    weights, batch, _, _ = reference(arch)
    cfg = base.get_reduced_config(arch)
    got, recomputed = {}, {}
    for policy in ("none", "full", "dots"):
        live = common.tree_map(lambda t: t.requires_grad_(),
                               params_from_numpy(weights, "cpu"))
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss = tf.loss_fn(live, tbatch, cfg, single_device_context(),
                          remat_policy=policy)
        with _CountBmm() as mode:
            got[policy] = torch.autograd.grad(loss,
                                              common.tree_leaves(live))
        recomputed[policy] = mode.calls
    for policy in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(got["none"],
                                                     got[policy])), policy
    none, full, dots = (recomputed[p] for p in ("none", "full", "dots"))
    assert full["weights"] > dots["weights"] == none["weights"]
    assert dots["batched"] >= none["batched"]
    assert full["batched"] == dots["batched"]


def test_unknown_remat_policy_raises(reference):
    weights, batch, _, _ = reference("qwen2p5_3b")
    cfg = base.get_reduced_config("qwen2p5_3b")
    with pytest.raises(ValueError, match="remat_policy"):
        _port_grad(cfg, weights, batch, remat_policy="offload")


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("router_kind", ["random", "tied"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_gradient_matches_reference(arch, router_kind):
    """The capacity dispatch's gradient: the gather of the kept slots, the
    gate weights of the stable top-k (a zero router ties every expert:
    the lower ids win, as ``lax.top_k``) and the ``index_add_`` scatter,
    against the reference's ``_moe_local``."""
    cfg = base.get_reduced_config(arch)
    E, d = cfg.num_experts, cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    rng = np.random.default_rng(7)
    args = [_rand(rng, 24, d), _rand(rng, d, E, scale=0.5),
            _rand(rng, E, d, f, scale=0.1), _rand(rng, E, d, f, scale=0.1),
            _rand(rng, E, f, d, scale=0.1)]
    if router_kind == "tied":
        args[1] = np.zeros_like(args[1])
    probe = _rand(rng, 24, d)

    def jloss(*a):
        y = jblocks._moe_local(*a, cfg=cfg, ctx=None, model_axis="",
                               ep_sharded=False, fsdp_axes=(), ff_axes=())
        return jnp.sum(y * probe)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *(jnp.asarray(a) for a in args))
    live = [torch.from_numpy(a).requires_grad_() for a in args]
    y = blocks._moe_local(*live, cfg=cfg)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(probe)), live)
    for name, g, w in zip(("x", "router", "w_gate", "w_up", "w_down"), got,
                          want):
        _close(g.numpy(), w, GRAD_TOL, name)


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_segment_sums_gradient_matches_reference(initial):
    """``ssd_chunked``'s gradient through the -inf-masked segment sums
    (finite everywhere), the chunk states and the inter-chunk recurrence."""
    rng = np.random.default_rng(11)
    b, s, h, p, g, n, chunk = 2, 32, 4, 8, 2, 6, 8
    args = [_rand(rng, b, s, h, p), np.abs(_rand(rng, b, s, h, scale=0.5)),
            -np.abs(_rand(rng, h)) - 0.1, _rand(rng, b, s, g, n),
            _rand(rng, b, s, g, n)]
    if initial:
        args.append(_rand(rng, b, h, p, n))
    ry, rs = _rand(rng, b, s, h, p), _rand(rng, b, h, p, n)

    def jloss(*a):
        y, st = jssm.ssd_chunked(*a[:5], chunk,
                                 initial_state=a[5] if initial else None)
        return jnp.sum(y * ry) + jnp.sum(st * rs)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args)))))(
        *(jnp.asarray(a) for a in args))
    live = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = ssm.ssd_chunked(*live[:5], chunk,
                            initial_state=live[5] if initial else None)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(ry))
                              + torch.sum(st * torch.from_numpy(rs)), live)
    for i, (gt, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(gt).all()), i
        _close(gt.numpy(), w, GRAD_TOL, f"argument {i}")


def _has_amax_backward(fn) -> bool:
    seen, stack = set(), [fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if "Amax" in type(node).__name__:
            return True
        stack.extend(nxt for nxt, _ in node.next_functions)
    return False


def test_cross_entropy_max_shift_takes_no_gradient():
    """The loss's max shift is outside the gradient, as the reference's
    ``stop_gradient``: no ``amax`` node in the backward graph, and the
    gradient on rows with tied maxima and padded labels equals JAX's."""
    rng = np.random.default_rng(2)
    logits = _rand(rng, 2, 5, 11, scale=3.0)
    logits[0, 0, [2, 7]] = 9.0            # a tie for the max
    logits[1, 3, :] = 1.5                 # a row that is all one value
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[1, 4] = tf.LABEL_PAD
    mask = labels != tf.LABEL_PAD

    want = jax.jit(jax.grad(lambda x: jcommon.cross_entropy_loss(
        x, jnp.maximum(labels, 0), mask)))(jnp.asarray(logits))
    live = torch.from_numpy(logits).requires_grad_()
    loss = common.cross_entropy_loss(
        live, torch.clamp(torch.from_numpy(labels), min=0).long(),
        torch.from_numpy(mask))
    assert not _has_amax_backward(loss.grad_fn)
    (got,) = torch.autograd.grad(loss, live)
    _close(got.numpy(), np.asarray(want), 1e-6)


@pytest.fixture(scope="module")
def reference_steps():
    """Per (arch, compress), once: the reference's state before and after
    one ``make_train_step``, and its metrics, as numpy."""
    ctx = jax_context()
    out = {}

    def get(arch, compress):
        key = (arch, compress)
        if key not in out:
            cfg = jbase.get_reduced_config(arch)
            weights, batch = _weights(arch), _batch(cfg)
            tcfg = jtl.TrainConfig(opt=jopt.AdamWConfig(**ADAMW),
                                   compress_grads=compress)
            params = jax.tree_util.tree_map(jnp.asarray, weights)
            state = {"params": params, "opt": jopt.init_opt_state(params)}
            if compress:
                # a nonzero carried residual, so the error feedback shows
                state["err"] = jax.tree_util.tree_map(
                    lambda p: jnp.full(p.shape, 1e-4, jnp.float32), params)
            before = jax.tree_util.tree_map(np.asarray, state)
            step = jtl.make_train_step(cfg, ctx, tcfg)
            new, metrics = step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            out[key] = (before, batch,
                        jax.tree_util.tree_map(np.asarray, new),
                        {k: float(v) for k, v in metrics.items()})
        return out[key]

    return get


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(compress, reference_steps):
    before, batch, want, want_metrics = reference_steps("qwen2p5_3b",
                                                        compress)
    cfg = base.get_reduced_config("qwen2p5_3b")
    tcfg = tl.TrainConfig(opt=opt.AdamWConfig(**ADAMW),
                          compress_grads=compress)
    state = train_state_from_numpy(before, "cpu")
    step = tl.make_train_step(cfg, single_device_context(), tcfg)
    params = state["params"]
    new, metrics = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert new is state and new["params"] is params    # updated in place
    assert set(metrics) == set(want_metrics) == {"loss", "grad_norm", "lr"}
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and v.ndim == 0
        _close(float(v), want_metrics[k], STEP_TOL, k)
    got = train_state_to_numpy(new)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert int(got["opt"]["count"]) == 1
    for (path, g), w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype, path
        _close(g, w, STEP_TOL, jax.tree_util.keystr(path))


def test_train_step_restores_the_deterministic_flag(reference):
    """A train step leaves the deterministic-algorithms setting as it
    found it; ``train`` runs its steps with it on and puts the earlier
    setting back after them, nested or not."""
    weights, batch, _, _ = reference("qwen2p5_3b")
    cfg = base.get_reduced_config("qwen2p5_3b")
    params = params_from_numpy(weights, "cpu")
    state = {"params": params, "opt": opt.init_opt_state(params)}
    step = tl.make_train_step(cfg, single_device_context(), tl.TrainConfig())
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert not torch.are_deterministic_algorithms_enabled()
    step(state, data)
    assert not torch.are_deterministic_algorithms_enabled()

    class Loader:
        seen = []

        def batch(self, i):
            self.seen.append(torch.are_deterministic_algorithms_enabled())
            return batch

    tl.train(cfg, single_device_context(), tl.TrainConfig(log_every=0),
             Loader(), 1, log=lambda *_: None, device="cpu")
    assert Loader.seen == [True]
    assert not torch.are_deterministic_algorithms_enabled()
    with tl.deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
        with tl.deterministic_algorithms():
            pass
        assert torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
