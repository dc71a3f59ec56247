"""Abstract inputs of every (arch x shape) dry-run cell, as tensors on
``meta`` (shapes and dtypes, no storage).

Each function returns an ``Abstract``: the tree of ``meta`` tensors, a tree
of the same structure holding each leaf's partition spec on the context's
mesh (``MeshContext.spec_for``: per dim None, a mesh axis name, or a tuple
of names), and a tree of each leaf's per-device shape on that mesh (the
dim over the product of its axes' sizes).  The specs are the JAX
package's ``launch/specs.py`` shardings, so a cell's layout on the
production meshes can be computed here; the port runs a cell on one card,
whose mesh has every axis of size 1.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ArchConfig
from ..models import transformer as tf
from ..models.common import tree_map
from ..sharding import MeshContext

# the assigned input-shape sets (LM shapes are seq_len x global_batch)
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


class Abstract(NamedTuple):
    tree: Any        # meta tensors
    specs: Any       # partition spec per leaf
    local: Any       # per-device shape per leaf


def shape_skip_reason(cfg: ArchConfig, shape: str) -> str | None:
    """DESIGN.md §5 skip rules."""
    if shape == "long_500k" and not cfg.subquadratic:
        return (
            "pure full-attention arch: 0.5M-token decode needs sub-quadratic "
            "attention (skip per assignment; DESIGN.md §5)"
        )
    return None


def _abstract(tree, specs, ctx: MeshContext) -> Abstract:
    return Abstract(tree, specs, tree_map(
        lambda t, s: ctx.local_shape(s, t.shape), tree, specs))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _spec(*parts) -> tuple:
    """A partition spec with a one-axis tuple normalised to its name."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def _batch_axes_for(B: int, ctx: MeshContext):
    """batch sharding with divisibility fallback (long_500k has B=1: the
    data axis idles — documented single-stream latency shape)."""
    bdp = ctx.batch_axes
    if bdp and B % ctx.axis_size(bdp) == 0:
        return bdp
    for ax in bdp or ():
        if B % ctx.mesh[ax] == 0 and ctx.mesh[ax] > 1:
            return (ax,)
    return None


def batch_specs(cfg: ArchConfig, shape: str, ctx: MeshContext, *,
                global_batch: int | None = None) -> Abstract:
    """The batch of a cell (``global_batch`` overrides the shape's)."""
    info = SHAPES[shape]
    B, S = global_batch or info["global_batch"], info["seq_len"]
    bdp = _batch_axes_for(B, ctx)
    tree, specs = {}, {}
    if info["kind"] in ("train", "prefill"):
        if cfg.frontend != "none":
            tree["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
            specs["embeds"] = _spec(bdp, None, None)
        else:
            tree["tokens"] = _meta((B, S), torch.int32)
            specs["tokens"] = _spec(bdp, None)
        if info["kind"] == "train":
            tree["labels"] = _meta((B, S), torch.int32)
            specs["labels"] = _spec(bdp, None)
    else:   # decode: one new token; S is the cache length
        tree["tokens"] = _meta((B, 1), torch.int32)
        specs["tokens"] = _spec(bdp, None)
    return _abstract(tree, specs, ctx)


def _cache_spec_for_path(path, leaf_shape, cfg: ArchConfig, ctx: MeshContext,
                         batch: int):
    """Sharding for one KV-cache leaf, by leaf name."""
    bdp = _batch_axes_for(batch, ctx)
    name = path[-1] if path and isinstance(path[-1], str) else ""
    model = ctx.model_axis

    def fits(dim, ax):
        return ax and leaf_shape[dim] % ctx.mesh[ax] == 0
    if name in ("k", "v"):          # (..., B, T, Hkv, hd)
        # shard the SEQ dim over model: divisible for every arch (32k % 16)
        # where head counts (1, 8, 24, 56...) often are not
        seq_ax = model if fits(len(leaf_shape) - 3, model) else None
        return _spec(*([None] * (len(leaf_shape) - 4)), bdp, seq_ax, None,
                     None)
    if name in ("ckv", "k_rope"):   # (..., B, T, r)
        seq_ax = model if fits(len(leaf_shape) - 2, model) else None
        return _spec(*([None] * (len(leaf_shape) - 3)), bdp, seq_ax, None)
    if name == "conv":              # (..., B, K-1, C)
        ch_ax = model if fits(len(leaf_shape) - 1, model) else None
        return _spec(*([None] * (len(leaf_shape) - 3)), bdp, None, ch_ax)
    if name == "ssm":               # (..., B, nh, hd, state)
        h_ax = model if fits(len(leaf_shape) - 3, model) else None
        return _spec(*([None] * (len(leaf_shape) - 4)), bdp, h_ax, None,
                     None)
    if name == "h":                 # (..., B, 1, w) rg-lru state
        w_ax = model if fits(len(leaf_shape) - 1, model) else None
        return _spec(*([None] * (len(leaf_shape) - 3)), bdp, None, w_ax)
    return _spec(*([None] * len(leaf_shape)))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_specs(cfg: ArchConfig, shape: str, ctx: MeshContext,
                dtype=None, *, global_batch: int | None = None) -> Abstract:
    """The decode cache of a cell (``global_batch`` overrides the
    shape's), from ``init_cache`` on ``meta``."""
    info = SHAPES[shape]
    B, S = global_batch or info["global_batch"], info["seq_len"]
    cache = tf.init_cache(cfg, B, S, dtype or torch.bfloat16, device="meta")
    specs = _map_with_path(
        lambda path, t: _cache_spec_for_path(path, t.shape, cfg, ctx, B),
        cache)
    return _abstract(cache, specs, ctx)


def param_specs_abstract(cfg: ArchConfig, ctx: MeshContext,
                         dtype=torch.bfloat16) -> Abstract:
    """Abstract params with production partition specs."""
    return _abstract(tf.abstract_model(cfg, dtype),
                     tf.model_shardings(cfg, ctx), ctx)


def opt_state_abstract(params: Abstract, ctx: MeshContext) -> Abstract:
    """Abstract AdamW state (float32 m / v shaped and laid out like the
    params, a 0-d int32 count)."""
    def f32_like(p):
        return _meta(p.shape, torch.float32)

    tree = {"m": tree_map(f32_like, params.tree),
            "v": tree_map(f32_like, params.tree),
            "count": _meta((), torch.int32)}
    specs = {"m": params.specs, "v": params.specs, "count": ()}
    return _abstract(tree, specs, ctx)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor of a tree."""
    from ..models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
