"""Int8 gradient compression with error feedback, as the JAX package's
``training/compression.py``.

Gradients are quantised to int8 with a per-tensor symmetric scale before
the (simulated) cross-pod reduce; the quantisation residual is carried in
an error-feedback buffer so the scheme stays unbiased over time.
``compressed_grads`` plugs between the gradient and the optimizer.  The
arithmetic is the reference's bit for bit: an IEEE division by the scale,
``torch.round`` rounding half to even as ``jnp.round`` does.

In a world of ranks each leaf is the rank's block of the global gradient
(after ``sharding.reduce_gradients``) and the error buffer the rank's
block: the per-tensor scale is the global tensor's, the ``pmax`` of the
blocks' max |x| over the axes the leaf is split over.
"""

from __future__ import annotations

import torch

from ..models.common import tree_map


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x, ctx=None, spec=None):
    """Per-tensor symmetric int8; returns (q, scale).  In a world (``ctx``)
    ``x`` is a block laid out by ``spec`` and the scale the whole
    tensor's."""
    amax = torch.max(torch.abs(x))
    if ctx is not None and ctx.world is not None:
        from ..sharding import axes_of, pmax

        amax = pmax(amax, ctx, [a for e in spec for a in axes_of(e)],
                    "compress")
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def compress_leaf(g, err, ctx=None, spec=None):
    """One leaf: returns (g_hat, new_err).  g_hat is what the wire carries
    (dequantised int8, in g's dtype); err accumulates the residual.  In a
    world the blocks of both laid out by ``spec``."""
    g32 = g.float() + err
    q, scale = _quantize(g32, ctx, spec)
    g_hat = _dequantize(q, scale)
    return g_hat.to(g.dtype), g32 - g_hat


def compressed_grads(grads, err_state, ctx=None, specs=None):
    """int8 + error feedback across a grad tree: (g_hat tree, new error
    tree).  In a world (``ctx``) the trees are the rank's blocks, laid out
    by ``specs`` (the same tree)."""
    if ctx is None or ctx.world is None:
        out = tree_map(compress_leaf, grads, err_state)   # leaves: pairs
    else:
        out = tree_map(lambda g, e, s: compress_leaf(g, e, ctx, s), grads,
                       err_state, specs)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
