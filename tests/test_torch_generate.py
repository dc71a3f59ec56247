"""The port's ``serving/engine.py`` ``generate`` against the JAX package's,
on the reduced configs with the reference's weights carried across: the
greedy tokens must be equal, or differ only from a step where the port's
top-2 logits lie within TIE_TOL of each other (a float tie that either
package may break either way).  The fp8 decode cache
(``torch.float8_e4m3fn``) against the reference's fp8 cache at the float32
tolerance (both round to e4m3 the same way), and against the port's own
float32 cache within the reference's bound (``tests/test_attention.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro.serving import engine as jengine
from repro.sharding import TRAIN_RULES
from repro.sharding import MeshContext as JMeshContext
from repro_torch.configs import base
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import GenerateResult, generate
from repro_torch.sharding import single_device_context
from torch_session_cache import one_thread  # noqa: F401 (fixture)
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

LM_ARCHS = [a for a in base.ARCH_IDS if a != "bwt_index"]
TOL = dict(rtol=1e-4, atol=1e-4)     # float32, CPU against CPU
TIE_TOL = 1e-4
PROMPT, NEW = 4, 8


@pytest.fixture(scope="module")
def jctx():
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    return JMeshContext(mesh, TRAIN_RULES)


def _weights(arch, seed=0):
    cfg = jbase.get_reduced_config(arch)
    params = jax.jit(lambda key: jtf.init_model(cfg, key, jnp.float32))(
        jax.random.key(seed))
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             params), "cpu")


def _prompts(cfg, B=2, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


def teacher_forced_logits(params, cfg, tokens):
    """The port's decode logits (steps, B, V) along ``tokens``."""
    ctx = single_device_context()
    B, T = tokens.shape
    cache = tf.init_cache(cfg, B, T, torch.float32, "cpu")
    out = []
    for pos in range(T - 1):
        logits, cache = tf.decode_step(
            params, cache, torch.from_numpy(tokens[:, pos:pos + 1]), pos,
            cfg, ctx)
        out.append(logits.numpy())
    return np.stack(out)


def assert_tokens_agree(params, cfg, want, got):
    """Equal, or each row differs first where the port's own top-2 logits
    along the reference's tokens are within TIE_TOL."""
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got[:, :PROMPT], want[:, :PROMPT])
    if np.array_equal(got, want):
        return
    logits = teacher_forced_logits(params, cfg, want)
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            top2 = np.sort(logits[diff[0] - 1, b])[-2:]
            assert top2[1] - top2[0] <= TIE_TOL, (b, diff[0], top2)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_greedy_tokens_match_reference(arch, jctx):
    jparams, params = _weights(arch)
    cfg = base.get_reduced_config(arch)
    prompts = _prompts(cfg)
    want = jengine.generate(jparams, jbase.get_reduced_config(arch), jctx,
                            prompts, NEW).tokens
    res = generate(params, cfg, single_device_context(), prompts, NEW)
    assert isinstance(res, GenerateResult) and res.tokens_per_s > 0
    assert res.tokens.shape == (2, PROMPT + NEW)
    assert_tokens_agree(params, cfg, want, res.tokens)


def test_sample_is_called_on_every_new_token(jctx):
    _, params = _weights("minitron_4b")
    cfg = base.get_reduced_config("minitron_4b")
    seen = []

    def sample(logits):
        seen.append(tuple(logits.shape))
        return torch.full((logits.shape[0],), 7)

    res = generate(params, cfg, single_device_context(), _prompts(cfg), NEW,
                   sample=sample)
    assert seen == [(2, cfg.vocab_size)] * NEW
    assert (res.tokens[:, PROMPT:] == 7).all()


def _decode_logits(step, params, cache, toks):
    out = []
    for pos in range(toks.shape[1]):
        logits, cache = step(params, cache, toks[:, pos:pos + 1], pos)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


@pytest.mark.parametrize("arch", ["qwen2p5_3b", "minicpm3_4b"])
def test_fp8_cache_matches_reference(arch, jctx):
    """The reference's ``TestFp8KVCache`` shapes: 6 decode steps into a
    cache of 8, float32 weights."""
    jparams, params = _weights(arch, seed=2)
    cfg = base.get_reduced_config(arch)
    jcfg = jbase.get_reduced_config(arch)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 6)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, jcfg,
                                                         jctx))
    want = _decode_logits(
        lambda p, c, t, pos: jstep(p, c, jnp.asarray(t), jnp.int32(pos)),
        jparams, jtf.init_cache(jcfg, 1, 8, jnp.float8_e4m3fn), toks)
    ctx = single_device_context()

    def step(p, c, t, pos):
        return tf.decode_step(p, c, torch.from_numpy(t), pos, cfg, ctx)

    got = _decode_logits(step, params, tf.init_cache(
        cfg, 1, 8, torch.float8_e4m3fn, "cpu"), toks)
    np.testing.assert_allclose(got, want, **TOL)
    full = _decode_logits(step, params, tf.init_cache(
        cfg, 1, 8, torch.float32, "cpu"), toks)
    assert np.isfinite(got).all()
    assert np.abs(full - got).max() / max(np.abs(full).max(), 1e-6) < 0.15


def test_fp8_generate_runs(jctx):
    _, params = _weights("qwen2p5_3b")
    cfg = base.get_reduced_config("qwen2p5_3b")
    res = generate(params, cfg, single_device_context(), _prompts(cfg), NEW,
                   cache_dtype=torch.float8_e4m3fn)
    assert res.tokens.shape == (2, PROMPT + NEW)
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
