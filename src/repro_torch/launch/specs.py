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
from ..sharding import (
    MeshContext,
    batch_axes_for,
    cache_spec,
    normalised_spec as _spec,
)

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


def batch_specs(cfg: ArchConfig, shape: str, ctx: MeshContext, *,
                global_batch: int | None = None,
                seq_len: int | None = None) -> Abstract:
    """The batch of a cell (``global_batch`` / ``seq_len`` override the
    shape's)."""
    info = SHAPES[shape]
    B, S = global_batch or info["global_batch"], seq_len or info["seq_len"]
    bdp = batch_axes_for(B, ctx)
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


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_specs(cfg: ArchConfig, shape: str, ctx: MeshContext,
                dtype=None, *, global_batch: int | None = None,
                seq_len: int | None = None) -> Abstract:
    """The decode cache of a cell (``global_batch`` / ``seq_len``
    override the shape's), from ``init_cache`` on ``meta``, each leaf
    laid out by its name (``sharding.cache_spec``, the rule a world's
    ``init_cache`` lays its blocks out by)."""
    info = SHAPES[shape]
    B, S = global_batch or info["global_batch"], seq_len or info["seq_len"]
    cache = tf.init_cache(cfg, B, S, dtype or torch.bfloat16, device="meta")
    specs = _map_with_path(
        lambda path, t: cache_spec(path[-1], t.shape, ctx, B), cache)
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


def local_nbytes(abstract: Abstract) -> int:
    """Bytes of one rank's blocks of every leaf of ``abstract`` (each
    leaf's per-device shape on the context's mesh)."""
    from ..models.common import tree_leaves

    total = 0
    for t, shape in zip(tree_leaves(abstract.tree),
                        tree_leaves(abstract.local)):
        n = t.element_size()
        for size in shape:
            n *= size
        total += n
    return total


def tree_nbytes(tree) -> int:
    """Bytes of every tensor of a tree."""
    from ..models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
