"""The port's LM harness (configs, sharding specs, models/*) against the JAX
package's on the same weights: for every reduced config, weights made by
the reference's ``init_model`` are carried across (``models/convert.py``)
and ``forward`` logits, ``loss_fn`` and 8 ``decode_step`` logits are held
against the reference's at float32, within TOL.  The MoE configs' routing
(expert ids, kept capacity slots) must be equal first.

The reference runs under a one-device mesh with Auto axis types: its own
``single_device_context()`` builds Explicit axes under jax 0.9, where its
decode step raises (ROADMAP C).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import base as jbase
from repro.models import blocks as jblocks
from repro.models import transformer as jtf
from repro.sharding import MeshContext as JMeshContext
from repro.sharding import TRAIN_RULES as J_TRAIN_RULES
from repro.sharding import DECODE_RULES as J_DECODE_RULES
from repro_torch.configs import base
from repro_torch.configs.bwt_index import BWTIndexConfig
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import blocks, common, ssm
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.sharding import (
    DECODE_RULES,
    TRAIN_RULES,
    MeshContext,
    single_device_context,
)
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

LM_ARCHS = [a for a in base.ARCH_IDS if a != "bwt_index"]
MOE_ARCHS = ["deepseek_v2_236b", "llama4_maverick_400b_a17b"]
TOL = dict(rtol=1e-4, atol=1e-4)     # float32, CPU against CPU
B, S, DECODE_STEPS = 2, 16, 8


def jax_context(rules=J_TRAIN_RULES):
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    return JMeshContext(mesh, rules)


def _batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
    return toks, np.roll(toks, -1, 1), embeds


@pytest.fixture(scope="module")
def reference():
    """Per arch, computed once on first use: (weights as numpy, forward
    logits, loss, embeds logits or None, decode logits (steps, B, V))."""
    ctx = jax_context()
    out = {}

    def get(arch):
        if arch in out:
            return out[arch]
        cfg = jbase.get_reduced_config(arch)
        params = jax.jit(lambda key: jtf.init_model(cfg, key, jnp.float32))(
            jax.random.key(0))
        toks, labels, embeds = _batch(cfg)

        @jax.jit
        def fwd(p, toks, labels, embeds):
            batch = {"tokens": toks, "labels": labels}
            logits = jtf.forward(p, batch, cfg, ctx)
            loss = jtf.loss_fn(p, batch, cfg, ctx)
            e = (jtf.forward(p, {"embeds": embeds}, cfg, ctx)
                 if cfg.frontend != "none" else logits)
            return logits, loss, e

        logits, loss, e_logits = fwd(params, toks, labels, embeds)
        step = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos,
                                                             cfg, ctx))
        cache = jtf.init_cache(cfg, B, DECODE_STEPS, jnp.float32)
        dec = []
        for pos in range(DECODE_STEPS):
            lg, cache = step(params, cache, jnp.asarray(toks[:, pos:pos + 1]),
                             jnp.int32(pos))
            dec.append(np.asarray(lg))
        out[arch] = (jax.tree_util.tree_map(np.asarray, params),
                     np.asarray(logits), float(loss),
                     np.asarray(e_logits) if cfg.frontend != "none" else None,
                     np.stack(dec))
        return out[arch]

    return get


def _port(arch, reference):
    cfg = base.get_reduced_config(arch)
    return cfg, params_from_numpy(reference(arch)[0], "cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss_match_reference(arch, reference):
    _, want_logits, want_loss, want_embeds, _ = reference(arch)
    cfg, params = _port(arch, reference)
    toks, labels, embeds = _batch(cfg)
    ctx = single_device_context()
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    logits = tf.forward(params, batch, cfg, ctx)
    assert logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    loss = tf.loss_fn(params, batch, cfg, ctx)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    last = tf.forward(params, batch, cfg, ctx, last_token_only=True)
    np.testing.assert_allclose(last.numpy(), want_logits[:, -1:], **TOL)
    if want_embeds is not None:   # the frontend stubs take embeddings
        e = tf.forward(params, {"embeds": torch.from_numpy(embeds)}, cfg, ctx)
        np.testing.assert_allclose(e.numpy(), want_embeds, **TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_reference(arch, reference):
    want = reference(arch)[4]
    cfg, params = _port(arch, reference)
    toks, _, _ = _batch(cfg)
    ctx = single_device_context()
    cache = tf.init_cache(cfg, B, DECODE_STEPS, torch.float32, "cpu")
    for pos in range(DECODE_STEPS):
        logits, cache = tf.decode_step(
            params, cache, torch.from_numpy(toks[:, pos:pos + 1]), pos, cfg,
            ctx)
        assert logits.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), want[pos], **TOL)


def _jax_routing(xt, router, cfg):
    """The reference's routing and capacity dispatch (``_moe_local``,
    ``blocks.py:414-449``) on one device: expert ids and kept slots."""
    E, k = cfg.num_experts, cfg.top_k
    T = xt.shape[0]
    logits = jnp.einsum("td,de->te", xt, router).astype(jnp.float32)
    weights, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_expert = experts.reshape(T * k)
    flat_token = jnp.repeat(jnp.arange(T)[:, None], k, axis=1).reshape(-1)
    order = jnp.argsort(flat_expert)
    e_sorted, t_sorted = flat_expert[order], flat_token[order]
    C = max(1, int(cfg.capacity_factor * T * k / E))
    mine = jnp.arange(E)
    starts = jnp.searchsorted(e_sorted, mine, side="left")
    counts = jnp.searchsorted(e_sorted, mine, side="right") - starts
    take = jnp.clip(starts[:, None] + jnp.arange(C)[None, :], 0, T * k - 1)
    valid = jnp.arange(C)[None, :] < jnp.minimum(counts, C)[:, None]
    return (np.asarray(experts), np.asarray(jnp.where(valid, t_sorted[take],
                                                      0)), np.asarray(valid))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("router_kind", ["random", "tied"])
def test_moe_routing_and_output_match_reference(arch, router_kind, reference):
    """Expert ids (ties to the lower id, as lax.top_k), kept capacity slots
    (a stable argsort, as jnp.argsort) and the layer's output; a zero
    router ties every expert."""
    cfg, params = _port(arch, reference)
    layer = params["blocks"]["s0"]["ffn"]
    router = layer["router"][0]
    if router_kind == "tied":
        router = torch.zeros_like(router)
    xt = torch.from_numpy(np.random.default_rng(5).normal(
        size=(24, cfg.d_model)).astype(np.float32))
    _, experts, tok_idx, _, valid = blocks.moe_route(xt, router, cfg)
    w_experts, w_tok, w_valid = _jax_routing(jnp.asarray(xt.numpy()),
                                             jnp.asarray(router.numpy()), cfg)
    assert np.array_equal(experts.numpy(), w_experts)
    assert np.array_equal(valid.numpy(), w_valid)
    assert np.array_equal(tok_idx.numpy(), w_tok)
    if router_kind == "tied":
        assert (experts.numpy() == np.arange(cfg.top_k)).all()
    args = [layer[k][0] for k in ("w_gate", "w_up", "w_down")]
    got = blocks._moe_local(xt, router, *args, cfg=cfg)
    want = jblocks._moe_local(
        jnp.asarray(xt.numpy()), jnp.asarray(router.numpy()),
        *(jnp.asarray(a.numpy()) for a in args), cfg=cfg, ctx=None,
        model_axis="", ep_sharded=False, fsdp_axes=(), ff_axes=())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 512])
def test_attend_chunked_matches_reference(window):
    """The online-softmax path (S = 2048 > ATTN_CHUNK) and the materialised
    one, each against the reference's."""
    rng = np.random.default_rng(0)
    Bq, Sq, H, Hkv, hd = 1, 2048, 4, 2, 16
    q, k, v = (rng.normal(size=(Bq, Sq, h, hd)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    want = jblocks._attend_chunked(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=window)
    got = blocks._attend_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mask = blocks._causal_mask(Sq, Sq, window=window)
    naive = blocks._attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mask)
    np.testing.assert_allclose(naive.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "qwen2p5_3b"])
def test_chunked_layer_matches_reference(arch, reference):
    """One attention layer (MLA / GQA with bias) at S = 2048, which takes
    the chunked path in both packages."""
    cfg, params = _port(arch, reference)
    jparams = reference(arch)[0]
    x = (np.random.default_rng(1).normal(size=(1, 2048, cfg.d_model))
         * 0.1).astype(np.float32)
    p = common.tree_map(lambda t: t[0], params["blocks"]["s0"]["mixer"])
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                jparams["blocks"]["s0"]["mixer"])
    jctx, ctx = jax_context(), single_device_context()
    if cfg.attention == "mla":
        want = jblocks.mla_attention(jp, jnp.asarray(x), cfg, jctx)
        got = blocks.mla_attention(p, torch.from_numpy(x), cfg, ctx)
    else:
        want = jblocks.gqa_attention(jp, jnp.asarray(x), cfg, jctx)
        got = blocks.gqa_attention(p, torch.from_numpy(x), cfg, ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_activations_match_jax():
    """GELU is the tanh approximation; softplus agrees across torch's
    threshold (20) to float32 rounding."""
    x = np.linspace(-40, 40, 4001).astype(np.float32)
    np.testing.assert_allclose(common.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_max_ulp(
        torch.nn.functional.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(x)), maxulp=2)


def test_linear_recurrence_is_the_sequential_one():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 37, 3)).astype(np.float32))
    h, want = torch.zeros(2, 3), []
    for t in range(37):
        h = a[:, t] * h + x[:, t]
        want.append(h)
    np.testing.assert_allclose(ssm.linear_recurrence(a, x, 1).numpy(),
                               torch.stack(want, 1).numpy(), **TOL)


def test_params_round_trip_through_numpy(reference):
    cfg, params = _port("deepseek_v2_236b", reference)
    back = params_to_numpy(params)
    want = reference("deepseek_v2_236b")[0]
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, b)
    bf = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), want), "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert np.array_equal(bf["embed"].float().numpy(),
                          np.asarray(jnp.asarray(want["embed"], jnp.bfloat16),
                                     np.float32))


def test_lm_module_holds_the_same_tensors(reference):
    cfg, params = _port("recurrentgemma_2b", reference)
    model = tf.LM(cfg, params)
    names = dict(model.named_parameters())
    assert len(names) == len(common.tree_leaves(params))
    assert names["tree.blocks.s2.mixer.wq"].data_ptr() == \
        params["blocks"]["s2"]["mixer"]["wq"].data_ptr()
    toks, _, _ = _batch(cfg)
    want = reference("recurrentgemma_2b")[1]
    np.testing.assert_allclose(
        model({"tokens": torch.from_numpy(toks)}).numpy(), want, **TOL)
    cache = model.init_cache(B, 4)
    logits, _ = model.decode_step(cache, torch.from_numpy(toks[:, :1]), 0)
    np.testing.assert_allclose(logits.numpy(), reference(
        "recurrentgemma_2b")[4][0], **TOL)


def test_random_init_follows_the_specs():
    cfg = base.get_reduced_config("recurrentgemma_2b")
    g = torch.Generator().manual_seed(0)
    params = tf.init_model(cfg, g, torch.float32, "cpu")
    again = tf.init_model(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    mixer = params["blocks"]["s0"]["mixer"]
    assert (mixer["lambda_p"] == 1).all() and (mixer["b_a"] == 0).all()
    assert (params["final_norm"] == 0).all()
    w = cfg.lru_width
    assert abs(float(mixer["w_a"].std()) - 0.02 / int(np.sqrt(2 * w))) < 2e-3
    assert abs(float(params["embed"].std()) - 0.02) < 2e-3
    assert all(torch.equal(a, b) for a, b in zip(
        common.tree_leaves(params), common.tree_leaves(again)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_counts_and_full_shapes_match_reference(arch):
    """count_params, count_active_params and the full config's abstract
    shapes (meta tensors, no storage) equal the reference's."""
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    assert cfg == base.ArchConfig(**vars(jcfg))
    assert base.get_reduced_config(arch) == base.ArchConfig(
        **vars(jbase.get_reduced_config(arch)))
    assert tf.count_params(cfg) == jtf.count_params(jcfg)
    assert tf.count_active_params(cfg) == jtf.count_active_params(jcfg)
    got = tf.abstract_model(cfg)
    want = jtf.abstract_model(jcfg)
    assert jax.tree_util.tree_structure(
        common.tree_map(lambda t: 0, got)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0,
                                                            want))
    for a, b in zip(common.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.device.type == "meta" and a.dtype == torch.bfloat16
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("rules", ["train", "decode"])
@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "recurrentgemma_2b",
                                  "mamba2_1p3b", "qwen2p5_3b"])
def test_specs_on_the_production_mesh_match_reference(arch, rules, multi_pod):
    axes = make_production_mesh(multi_pod=multi_pod)
    jmesh = AbstractMesh(tuple(axes.values()), tuple(axes))
    ctx = MeshContext(axes, TRAIN_RULES if rules == "train" else DECODE_RULES)
    jctx = JMeshContext(jmesh, J_TRAIN_RULES if rules == "train"
                        else J_DECODE_RULES)
    cfg = base.get_config(arch)
    specs = common.tree_leaves(tf.model_specs(cfg))
    for s in specs:
        assert ctx.spec_for(s.axes, s.shape) == tuple(
            jctx.spec_for(s.axes, s.shape)), s
    got = tf.model_shardings(cfg, ctx)
    assert set(got) == set(tf.model_specs(cfg))
    assert got["lm_head"] == tuple(jctx.spec_for((None, "vocab"),
                                                 (cfg.d_model,
                                                  cfg.vocab_size)))


def test_mesh_shapes():
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16,
                                                    "model": 16}
    assert make_debug_mesh(1) == {"pod": 1, "data": 1, "model": 1}
    assert make_debug_mesh(4) == {"pod": 1, "data": 2, "model": 2}
    assert make_debug_mesh(8) == {"pod": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError, match="even"):
        make_debug_mesh(3)


def test_a_context_with_an_axis_over_one_raises(reference):
    """Model-parallel serving is not ported: no model function runs
    unsharded on a larger mesh."""
    cfg, params = _port("qwen2p5_3b", reference)
    ctx = MeshContext(make_debug_mesh(4), TRAIN_RULES)
    toks, _, _ = _batch(cfg)
    with pytest.raises(NotImplementedError, match="model-parallel"):
        tf.forward(params, {"tokens": torch.from_numpy(toks)}, cfg, ctx)
    cache = tf.init_cache(cfg, B, 4, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="model-parallel"):
        tf.decode_step(params, cache, torch.from_numpy(toks[:, :1]), 0, cfg,
                       ctx)
    p = common.tree_map(lambda t: t[0], params["blocks"]["s0"]["mixer"])
    x = torch.zeros(B, 1, cfg.d_model)
    with pytest.raises(NotImplementedError):
        blocks.gqa_decode(p, x, common.tree_map(lambda t: t[0],
                                                cache["blocks"]["s0"]), 0,
                          cfg, ctx)


def test_get_config_of_the_index_is_the_ports():
    assert isinstance(base.get_config("bwt_index"), BWTIndexConfig)
