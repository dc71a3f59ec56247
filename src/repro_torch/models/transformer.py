"""Decoder assembly: pattern-based layer stacking, forward, loss, and cached
decode — one code path for all ten LM architectures, as in the JAX
package's ``models/transformer.py``.

The layer pattern (cfg.layer_pattern, default by family) repeats over the
depth; the repeating groups' params are stacked on a leading ``groups``
index (the reference scans over it; here a Python loop walks it), and any
remainder / prefix layers stand alone.  DeepSeek's leading dense-FFN
layer(s) are the ``prefix``; RecurrentGemma's (rglru, rglru, attn) pattern
stacks 3-layer groups.

``forward`` and ``decode_step`` are functions of a dict of tensors, the
tree the JAX package's functions take (``models/convert.py`` carries one
across).  In a world of ranks (``sharding.world_context``) the tree and the
cache are this rank's blocks, the tokens are the global batch (each rank
keeps its rows) and the logits are the rank's block: rows over the batch
axes, vocab over model, the reference's ``("batch", None, "act_model")``
layout (``sharding.gather_global`` puts them together).  ``LM`` wraps
the same tensors as an ``nn.Module``.  ``loss_fn`` is differentiable, on
one device and in a world (there each rank's gradient is its share,
``sharding.py``): ``training/train_loop.py`` takes its gradient with
autograd, each stacked group rematerialised as ``remat_policy`` says.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from ..devices import resolve_device
from ..sharding import (
    MeshContext,
    all_gather,
    axes_of,
    constrain,
    psum,
    require_one_device,
    single_device_context,
)
from . import blocks, ssm
from .common import (
    ParamSpec,
    abstract_params,
    cross_entropy_loss,
    init_params,
    param_shardings,
    rms_norm,
    stack_specs,
    tree_leaves,
    tree_map,
    world_cross_entropy,
)

LABEL_PAD = -1


def layer_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.layer_pattern:
        return cfg.layer_pattern
    if cfg.family == "ssm":
        return ("ssm",)
    return ("attn",)


# ---------------------------------------------------------------------------
# per-layer specs / apply / cache
# ---------------------------------------------------------------------------

def _mixer_specs(kind: str, cfg: ArchConfig) -> dict:
    if kind in ("attn", "local_attn"):
        return blocks.mla_specs(cfg) if cfg.attention == "mla" else blocks.gqa_specs(cfg)
    if kind == "rglru":
        return ssm.rglru_specs(cfg)
    if kind == "ssm":
        return ssm.mamba2_specs(cfg)
    raise ValueError(kind)


def _layer_specs(kind: str, cfg: ArchConfig, *, moe: bool) -> dict:
    d = cfg.d_model
    specs = {
        "norm1": ParamSpec((d,), (None,), init="zeros"),
        "mixer": _mixer_specs(kind, cfg),
    }
    if kind != "ssm":  # mamba blocks have no separate FFN
        specs["norm2"] = ParamSpec((d,), (None,), init="zeros")
        specs["ffn"] = blocks.moe_specs(cfg) if moe else blocks.mlp_specs(cfg)
    return specs


def _apply_mixer(kind, p, x, cfg, ctx):
    if kind == "attn":
        if cfg.attention == "mla":
            return blocks.mla_attention(p, x, cfg, ctx)
        return blocks.gqa_attention(p, x, cfg, ctx)
    if kind == "local_attn":
        return blocks.gqa_attention(p, x, cfg, ctx, window=cfg.window)
    if kind == "rglru":
        return ssm.rglru_block(p, x, cfg, ctx)
    if kind == "ssm":
        return ssm.mamba2_block(p, x, cfg, ctx)
    raise ValueError(kind)


def _apply_layer(kind, p, x, cfg, ctx, *, moe: bool):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _apply_mixer(kind, p["mixer"], h, cfg, ctx)
    if kind != "ssm":
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        ffn = blocks.moe_block if moe else blocks.mlp
        x = x + ffn(p["ffn"], h, cfg, ctx)
    return x


def _mixer_decode(kind, p, x, cache, pos, cfg, ctx):
    if kind == "attn":
        if cfg.attention == "mla":
            return blocks.mla_decode(p, x, cache, pos, cfg, ctx)
        return blocks.gqa_decode(p, x, cache, pos, cfg, ctx)
    if kind == "local_attn":
        return blocks.gqa_decode(p, x, cache, pos, cfg, ctx, window=cfg.window)
    if kind == "rglru":
        return ssm.rglru_decode(p, x, cache, pos, cfg, ctx)
    if kind == "ssm":
        return ssm.mamba2_decode(p, x, cache, pos, cfg, ctx)
    raise ValueError(kind)


def _apply_layer_decode(kind, p, x, cache, pos, cfg, ctx, *, moe: bool):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    mixed, cache = _mixer_decode(kind, p["mixer"], h, cache, pos, cfg, ctx)
    x = x + mixed
    if kind != "ssm":
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        ffn = blocks.moe_block if moe else blocks.mlp
        x = x + ffn(p["ffn"], h, cfg, ctx)
    return x, cache


def _mixer_cache(kind, cfg: ArchConfig, batch: int, max_len: int, dtype,
                 device, ctx=None):
    if kind == "attn":
        if cfg.attention == "mla":
            return blocks.mla_init_cache(cfg, batch, max_len, dtype, device,
                                         ctx)
        return blocks.gqa_init_cache(cfg, batch, max_len, dtype, device, ctx)
    if kind == "local_attn":
        return blocks.gqa_init_cache(cfg, batch, min(cfg.window, max_len),
                                     dtype, device, ctx)
    if kind == "rglru":
        return ssm.rglru_init_cache(cfg, batch, dtype, device, ctx)
    if kind == "ssm":
        return ssm.mamba2_init_cache(cfg, batch, dtype, device, ctx)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# model specs / init
# ---------------------------------------------------------------------------

def _layer_plan(cfg: ArchConfig):
    """(prefix_kinds, pattern, groups, suffix_kinds): prefix layers are the
    leading dense-FFN layers; suffix is the non-divisible remainder."""
    pat = layer_pattern(cfg)
    prefix = cfg.first_dense_layers
    rest = cfg.num_layers - prefix
    groups, rem = divmod(rest, len(pat))
    return (pat[:1] * prefix, pat, groups, pat[:rem])


def model_specs(cfg: ArchConfig) -> dict:
    moe = cfg.num_experts > 0
    prefix_kinds, pat, groups, suffix_kinds = _layer_plan(cfg)
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", None)),
        "final_norm": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size), (None, "vocab")),
        "prefix": [
            _layer_specs(k, cfg, moe=False) for k in prefix_kinds
        ],
        "blocks": {
            f"s{i}": stack_specs(_layer_specs(k, cfg, moe=moe), groups)
            for i, k in enumerate(pat)
        } if groups else {},
        "suffix": [
            _layer_specs(k, cfg, moe=moe) for k in suffix_kinds
        ],
    }
    return specs


def init_model(cfg: ArchConfig, generator: torch.Generator,
               dtype=torch.bfloat16, device=None, ctx: MeshContext | None = None):
    """Random weights from ``generator`` (see ``common.init_params``); in a
    world (``ctx``) this rank's blocks of the same weights."""
    return init_params(model_specs(cfg), generator, dtype, device, ctx)


def abstract_model(cfg: ArchConfig, dtype=torch.bfloat16):
    return abstract_params(model_specs(cfg), dtype)


def model_shardings(cfg: ArchConfig, ctx: MeshContext):
    return param_shardings(model_specs(cfg), ctx)


def count_params(cfg: ArchConfig) -> int:
    leaves = tree_leaves(model_specs(cfg))
    return int(sum(np.prod(s.shape) for s in leaves))


def count_active_params(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    if cfg.num_experts == 0:
        return count_params(cfg)
    total = count_params(cfg)
    f = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * f
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    inactive = moe_layers * (cfg.num_experts - cfg.top_k) * per_expert
    return total - inactive


def _group(tree, g: int):
    """Group ``g`` of a stacked tree (views: writes reach the stack)."""
    return tree_map(lambda t: t[g], tree)


def _groups(tree, groups: int) -> list:
    """Every group of a stacked tree, from one ``unbind`` per leaf: its
    backward stacks the groups' gradients once, where a ``t[g]`` per group
    would add a zero-padded stack-sized gradient per group."""
    if not groups:
        return []
    parts = tree_map(lambda t: t.unbind(0), tree)     # leaves: tuples
    return [tree_map(lambda p, g=g: p[g], parts) for g in range(groups)]


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "dots", "none")


def _save_weight_products(ctx, op, *args, **kwargs):
    """The selective-checkpoint counterpart of the reference's
    ``dots_with_no_batch_dims_saveable``: keep the products with no batch
    dimension (``mm`` / ``addmm``, and the ``bmm`` of batch 1 that
    ``torch.einsum`` makes of a ``bsd,dh`` weight product), recompute the
    rest, attention's batched ``bmm`` included.  (A batched contraction
    whose batch dims multiply to 1, e.g. attention at B = 1 over one KV
    head, is kept too: the memory differs, never the values.)"""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, policy: str):
    """``body`` (x, group params) -> x under ``policy``: "full" keeps only
    each group's input and recomputes its pass in the backward (the
    reference's ``jax.checkpoint`` of the scan body), "dots" keeps the
    weight products too, "none" keeps everything."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    if policy == "none" or not torch.is_grad_enabled():
        return body
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    return functools.partial(checkpoint, body, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _world_call(ctx: MeshContext, batch: int) -> MeshContext:
    """The context of one call in a world: its global batch set."""
    return dataclasses.replace(ctx, batch=batch)


def _rows(t, ctx: MeshContext):
    """This rank's rows of a global batch-major tensor (``t`` off a
    world)."""
    if ctx.world is None:
        return t
    return ctx.local_block(t, ctx.spec_for(("batch",) + (None,) * (t.ndim - 1),
                                           t.shape))


def _embed(table, tokens, cfg: ArchConfig, ctx: MeshContext):
    """Rows of the embedding table.  With the vocab split over axes that
    the rows are not split over, each rank looks up the ids of its block
    (zeros elsewhere) and a psum over them adds the blocks' rows; with
    the rows split over them too (the batch over every axis), the table
    is gathered whole first."""
    tokens = tokens.long()
    if ctx.world is None:
        return table[tokens]
    spec = ctx.spec_for(("vocab", None), (cfg.vocab_size, cfg.d_model))
    vaxes = axes_of(spec[0])
    if not vaxes:
        return table[tokens]
    rows = ctx.spec_for(("batch", None), (ctx.batch, 1))[0]
    if set(vaxes) & set(axes_of(rows)):
        return all_gather(table, ctx, vaxes, 0)[tokens]
    v0, vl = blocks.model_block(ctx, spec[0], cfg.vocab_size)
    local = tokens - v0
    hit = (local >= 0) & (local < vl)
    x = torch.where(hit[..., None], table[local.clamp(0, vl - 1)], 0)
    return psum(x, ctx, vaxes)


def _head(w, ctx: MeshContext, logits_spec, vocab: int):
    """The lm_head (d, this rank's vocab block) as the logits' layout
    ``logits_spec`` wants its vocab dim: the rank's own block where the
    two split the vocab alike, else gathered whole and cut to the logits'
    block."""
    if ctx.world is None:
        return w
    spec = ctx.spec_for((None, "vocab"), (w.shape[0], vocab))
    if axes_of(spec[1]) == axes_of(logits_spec[-1]):
        return w
    w = all_gather(w, ctx, axes_of(spec[1]), 1)
    axes = axes_of(logits_spec[-1])
    n = vocab // ctx.axis_size(axes)
    i = ctx.coordinate(axes)
    return w[:, i * n:(i + 1) * n]


def _inputs(params, batch, cfg: ArchConfig, ctx: MeshContext):
    """The first activation (this rank's rows): embeddings given to a
    frontend stub, or the tokens' rows of the table."""
    if cfg.frontend != "none" and "embeds" in batch:
        x = _rows(batch["embeds"], ctx)
        B, S = batch["embeds"].shape[:2]
    else:
        x = _embed(params["embed"], _rows(batch["tokens"], ctx), cfg, ctx)
        B, S = batch["tokens"].shape[:2]
    return constrain(x.to(params["lm_head"].dtype), ctx,
                     ("batch", None, None), (B, S, cfg.d_model))


def forward(params, batch, cfg: ArchConfig, ctx: MeshContext, *,
            remat_policy: str = "full", scan_unroll: int | bool = 1,
            last_token_only: bool = False):
    """Logits for a full sequence.  batch: {'tokens' (B,S)} or
    {'embeds' (B,S,d)} for stub-frontend archs.

    ``remat_policy`` ("full", "dots" or "none") rematerialises each stacked
    group's pass when a gradient is taken (``_remat``); with grad mode off
    it changes nothing.  ``scan_unroll`` is the reference's signature and
    does nothing: the Python loop over the groups is already unrolled.
    In a world the batch is global and the logits this rank's block."""
    require_one_device(ctx)
    if ctx.world is not None:
        src = batch["embeds"] if (cfg.frontend != "none"
                                  and "embeds" in batch) else batch["tokens"]
        ctx = _world_call(ctx, src.shape[0])
    return _forward(params, batch, cfg, ctx, remat_policy, last_token_only)


def _forward(params, batch, cfg: ArchConfig, ctx: MeshContext,
             remat_policy: str, last_token_only: bool):
    x = _inputs(params, batch, cfg, ctx)

    moe = cfg.num_experts > 0
    prefix_kinds, pat, groups, suffix_kinds = _layer_plan(cfg)

    for p_layer, kind in zip(params["prefix"], prefix_kinds):
        x = _apply_layer(kind, p_layer, x, cfg, ctx, moe=False)

    def body(x, group_params):
        for i, kind in enumerate(pat):
            x = _apply_layer(kind, group_params[f"s{i}"], x, cfg, ctx, moe=moe)
        return x

    body = _remat(body, remat_policy)
    for group_params in _groups(params["blocks"], groups):
        x = body(x, group_params)

    for p_layer, kind in zip(params["suffix"], suffix_kinds):
        x = _apply_layer(kind, p_layer, x, cfg, ctx, moe=moe)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_token_only:
        x = x[:, -1:, :]  # serving prefill: only the final position's logits
    shape = (ctx.batch_of(x), x.shape[1], cfg.vocab_size)
    head = _head(params["lm_head"], ctx,
                 ctx.spec_for(("batch", None, "act_model"), shape),
                 cfg.vocab_size)
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return constrain(logits, ctx, ("batch", None, "act_model"), shape)


def loss_fn(params, batch, cfg: ArchConfig, ctx: MeshContext, *,
            remat_policy: str = "full", scan_unroll: int | bool = 1):
    """Mean next-token loss over labels != LABEL_PAD (float32);
    differentiable, with ``forward``'s ``remat_policy``.  In a world the
    batch is global, the value the global loss on every rank and the
    gradient this rank's share (``common.world_cross_entropy``):
    ``sharding.reduce_gradients`` makes it the rank's block of the
    global gradient."""
    logits = forward(params, batch, cfg, ctx, remat_policy=remat_policy,
                     scan_unroll=scan_unroll)
    labels = batch["labels"]
    mask = labels != LABEL_PAD
    labels = torch.clamp(labels, min=0).long()
    if ctx.world is None:
        return cross_entropy_loss(logits, labels, mask)
    return world_cross_entropy(logits, labels, mask, ctx,
                               (*labels.shape, cfg.vocab_size))


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               ctx: MeshContext | None = None):
    """Zeroed decode cache for ``batch`` sequences of up to ``max_len``
    tokens: the prefix / stacked groups / suffix layers' caches (KV
    entries in ``dtype``, SSM and LRU states in float32).  In a world
    (``ctx``) this rank's blocks: its rows of the global ``batch``, and
    for attention the reference's sequence split (``sharding.cache_spec``:
    its positions over model, every kv head or the whole latent; the whole
    sequence where model does not divide it), for SSM / LRU states its
    channels."""
    device = resolve_device(device, allow_meta=True)
    prefix_kinds, pat, groups, suffix_kinds = _layer_plan(cfg)

    def make(kind):
        return _mixer_cache(kind, cfg, batch, max_len, dtype, device, ctx)

    def stack(tree, n):
        return tree_map(lambda x: x[None].repeat(n, *([1] * x.ndim)), tree)

    return {
        "prefix": [make(k) for k in prefix_kinds],
        "blocks": {
            f"s{i}": stack(make(k), groups) for i, k in enumerate(pat)
        } if groups else {},
        "suffix": [make(k) for k in suffix_kinds],
    }


def decode_step(params, cache, tokens, pos: int, cfg: ArchConfig,
                ctx: MeshContext, *, scan_unroll: int | bool = 1,
                max_len: int | None = None):
    """One decode step.  tokens (B, 1) int; pos the new token's index.
    Writes the cache in place; returns (logits (B, V), the cache).  In a
    world the tokens are the global batch, the cache and the logits this
    rank's blocks; each attention layer scores its rank's positions and
    combines the ranks' partial softmaxes over model.  ``max_len``, the
    length ``init_cache`` was given, is needed there only where a rank's
    block does not tell it (a block that model does not divide: the
    whole cache, or one of model's)."""
    require_one_device(ctx)
    if ctx.world is None:
        return _decode_step(params, cache, tokens, pos, cfg, ctx)
    ctx = dataclasses.replace(_world_call(ctx, tokens.shape[0]),
                              cache_len=max_len)
    with torch.no_grad():
        return _decode_step(params, cache, tokens, pos, cfg, ctx)


def _decode_step(params, cache, tokens, pos: int, cfg: ArchConfig,
                 ctx: MeshContext):
    x = _inputs(params, {"tokens": tokens}, cfg, ctx)
    moe = cfg.num_experts > 0
    prefix_kinds, pat, groups, suffix_kinds = _layer_plan(cfg)
    pos = int(pos)

    for p_layer, kind, c in zip(params["prefix"], prefix_kinds,
                                cache["prefix"]):
        x, _ = _apply_layer_decode(kind, p_layer, x, c, pos, cfg, ctx,
                                   moe=False)

    for g in range(groups):
        group_params = _group(params["blocks"], g)
        group_cache = _group(cache["blocks"], g)
        for i, kind in enumerate(pat):
            x, _ = _apply_layer_decode(
                kind, group_params[f"s{i}"], x, group_cache[f"s{i}"],
                pos, cfg, ctx, moe=moe,
            )

    for p_layer, kind, c in zip(params["suffix"], suffix_kinds,
                                cache["suffix"]):
        x, _ = _apply_layer_decode(kind, p_layer, x, c, pos, cfg, ctx,
                                   moe=moe)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    shape = (ctx.batch_of(x), cfg.vocab_size)
    head = _head(params["lm_head"], ctx,
                 ctx.spec_for(("batch", "act_model"), shape), cfg.vocab_size)
    logits = torch.einsum("bsd,dv->bsv", x, head)[:, 0]
    return constrain(logits, ctx, ("batch", "act_model"), shape), cache


# ---------------------------------------------------------------------------
# the same tensors as an nn.Module
# ---------------------------------------------------------------------------

class _Node(nn.Module):
    """One dict of the param tree: tensors as parameters, dicts as child
    nodes, lists as ``ModuleList`` s of nodes."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                setattr(self, k, _Node(v))
            elif isinstance(v, list):
                setattr(self, k, nn.ModuleList(_Node(x) for x in v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self) -> dict:
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            if isinstance(v, _Node):
                out[k] = v.tree()
            elif isinstance(v, nn.ModuleList):
                out[k] = [x.tree() for x in v]
            else:
                out[k] = v
        return out


class LM(nn.Module):
    """An LM of config ``cfg`` over a param tree (``params``, or random
    weights from ``generator``).  The parameters are the tree's tensors
    (no copy); ``forward`` / ``decode_step`` call the module functions
    above on ``params()``.  The parameters take no gradient here: training
    runs on the param tree itself (``training/train_loop.py``
    ``make_train_step`` / ``train``, ``launch/train.py``)."""

    def __init__(self, cfg: ArchConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None,
                 ctx: MeshContext | None = None):
        super().__init__()
        if params is None:
            params = init_model(cfg, generator, dtype, device)
        self.cfg = cfg
        self.ctx = ctx or single_device_context()
        self.tree = _Node(params)

    def params(self) -> dict:
        return self.tree.tree()

    def forward(self, batch: dict, *, last_token_only: bool = False):
        return forward(self.params(), batch, self.cfg, self.ctx,
                       last_token_only=last_token_only)

    def init_cache(self, batch: int, max_len: int, dtype=None):
        p = self.tree.embed
        return init_cache(self.cfg, batch, max_len, dtype or p.dtype,
                          p.device, self.ctx)

    def decode_step(self, cache, tokens, pos: int):
        return decode_step(self.params(), cache, tokens, pos, self.cfg,
                           self.ctx)
