"""Int8 gradient compression with error feedback, as the JAX package's
``training/compression.py``.

Gradients are quantised to int8 with a per-tensor symmetric scale before
the (simulated) cross-pod reduce; the quantisation residual is carried in
an error-feedback buffer so the scheme stays unbiased over time.
``compressed_grads`` plugs between the gradient and the optimizer.  The
arithmetic is the reference's bit for bit: an IEEE division by the scale,
``torch.round`` rounding half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from ..models.common import tree_map


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x):
    """Per-tensor symmetric int8; returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def compress_leaf(g, err):
    """One leaf: returns (g_hat, new_err).  g_hat is what the wire carries
    (dequantised int8, in g's dtype); err accumulates the residual."""
    g32 = g.float() + err
    q, scale = _quantize(g32)
    g_hat = _dequantize(q, scale)
    return g_hat.to(g.dtype), g32 - g_hat


def compressed_grads(grads, err_state):
    """int8 + error feedback across a grad tree: (g_hat tree, new error
    tree)."""
    out = tree_map(compress_leaf, grads, err_state)     # leaves: pairs
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
