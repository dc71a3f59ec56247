"""Carry an LM param tree, or a train state, across packages as numpy
arrays.

The JAX package's ``init_model`` tree (dicts, the ``prefix`` / ``suffix``
lists, the stacked ``blocks/s{i}`` groups) and this package's have the same
keys and shapes, so the mapping is leaf by leaf.  bfloat16 arrays (the
JAX package's ``ml_dtypes`` type) go through float32, which holds every
bfloat16 value exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve_device
from .common import tree_map


def _leaf_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def params_from_numpy(tree, device=None, ctx=None, shardings=None):
    """A tree of numpy arrays (the JAX package's params or train state
    through ``np.asarray``) as tensors on ``device`` (the card unless the
    CPU is asked for), leaf by leaf, dtypes kept.  In a world (``ctx`` of
    ``sharding.world_context``) each leaf is this rank's block by its
    partition spec in ``shardings`` (``transformer.model_shardings(cfg,
    ctx)``, the same tree)."""
    device = resolve_device(device)
    if ctx is None or ctx.world is None:
        return tree_map(lambda a: _leaf_to_tensor(a, device), tree)
    if shardings is None:
        raise ValueError("a world's params need their shardings "
                         "(transformer.model_shardings(cfg, ctx))")
    return tree_map(lambda a, spec: _leaf_to_tensor(
        np.asarray(a)[ctx.block(spec, np.shape(a))], device), tree,
        shardings)


def params_to_numpy(params):
    """A tree of tensors (params or a train state) as numpy arrays on the
    host (bfloat16 as float32, as the reference's checkpoints store it)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, params)


# a train state {params, opt: {m, v, count}, err?} crosses packages as any
# tree does
train_state_from_numpy = params_from_numpy
train_state_to_numpy = params_to_numpy
