"""Module-less parameter system + shared layers.

A model is described by a tree (dicts and lists) of ``ParamSpec`` (shape,
logical axes, initializer).  From the same spec tree come:
  * real parameters           (``init_params``)
  * abstract parameters       (``abstract_params``, tensors on ``meta``)
  * partition specs           (``param_shardings``, via sharding.MeshContext)

Apply functions take plain dict trees of tensors, as the JAX package's do,
so the two packages' trees map onto each other key for key
(``models/convert.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..devices import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]           # logical axis names, len == ndim
    init: str = "normal"                   # 'normal' | 'zeros' | 'ones' | 'small'
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and lists (and the leaves
    at the same places of the ``rest`` trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order of the JAX package's flattening (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _make(spec: ParamSpec, generator: torch.Generator, dtype, device,
          ctx=None):
    """One leaf; in a world (``ctx.world``) this rank's block of it, the
    whole leaf drawn and dropped again so every rank draws the same
    numbers."""
    shape = spec.shape
    spec_ = None
    if ctx is not None and ctx.world is not None:
        spec_ = ctx.spec_for(spec.axes, spec.shape)
        shape = ctx.local_shape(spec_, spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    scale = spec.scale
    if spec.init == "small":
        scale = spec.scale / max(1, int(np.sqrt(np.prod(spec.shape[:-1])
                                                or 1)))
    x = torch.randn(spec.shape, generator=generator, device=generator.device)
    if spec_ is None:
        return (x * scale).to(device=device, dtype=dtype)
    return (ctx.local_block(x, spec_) * scale).to(device=device, dtype=dtype)


def init_params(spec_tree, generator: torch.Generator,
                dtype=torch.float32, device=None, ctx=None):
    """Real parameters: normal x scale, zeros, ones or ``small`` (scale over
    the square root of the fan-in) per spec, drawn from ``generator`` (on
    its device), then placed on ``device`` (the card unless the CPU is
    asked for).  The values are this generator's, not ``jax.random``'s.
    In a world (``ctx`` of ``sharding.world_context``) each leaf is this
    rank's block by ``ctx.spec_for``, the same numbers as the single-device
    draw; one whole leaf at a time is made and freed."""
    device = resolve_device(device)
    return tree_map(lambda s: _make(s, generator, dtype, device, ctx),
                    spec_tree)


def abstract_params(spec_tree, dtype=torch.float32):
    """The parameter tree as tensors on the ``meta`` device (shapes and
    dtypes, no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), spec_tree)


def param_shardings(spec_tree, ctx):
    """The partition spec (``ctx.spec_for``) of every parameter."""
    return tree_map(lambda s: ctx.spec_for(s.axes, s.shape), spec_tree)


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Spec tree for ``n`` stacked copies of a layer."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), (axis_name, *s.axes), s.init,
                            s.scale),
        spec_tree)


# ---------------------------------------------------------------------------
# shared layers
# ---------------------------------------------------------------------------

def einsum(eq: str, *operands):
    """``torch.einsum`` over operands promoted to one dtype, as
    ``jnp.einsum`` promotes mixed dtypes."""
    dt = operands[0].dtype
    for o in operands[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in operands))


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim) or (..., seq, head_dim);
    positions: (..., seq) int."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., seq, hd/2)
    if x.ndim == angles.ndim + 1:                              # heads present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits, labels, mask=None):
    """Mean negative log-likelihood over unmasked positions (float32):
    logits (B, S, V) any float dtype, labels (B, S) int.  The label logit
    is selected by an index comparison, never a float one-hot.  The max
    shift takes no gradient (the reference's ``stop_gradient``): its terms
    cancel exactly, and ``amax``'s backward would split rounding noise
    among tied maxima."""
    logits = logits.float()
    vmax = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - vmax
    logsumexp = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    is_label = vocab == labels[..., None]
    label_logit = torch.sum(torch.where(is_label, shifted, 0.0), dim=-1)
    nll = logsumexp - label_logit
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class _Seeded(torch.autograd.Function):
    """``value`` forward, the gradient passed to ``share``: a loss whose
    value is the global one and whose backward seeds this rank's share."""

    @staticmethod
    def forward(fctx, share, value):
        return value.clone()

    @staticmethod
    def backward(fctx, g):
        return g, None


def world_cross_entropy(logits, labels, mask, ctx, shape):
    """``cross_entropy_loss`` in a world of ranks: ``logits`` this rank's
    block of the global (B, S, V) ``shape`` laid out as the reference's
    ``("batch", None, "act_model")``, ``labels`` / ``mask`` the global
    (B, S).  A vocab-parallel cross entropy: the row max a ``pmax`` over
    the vocab's axes (no gradient, as on one device), the sum of
    exponentials and the label logit (taken where the label falls in this
    rank's vocab block) one ``psum`` over them, the masked sum over the
    global count of unmasked labels (a psum over the rows' axes).

    The value is the global mean on every rank; the gradient is this
    rank's share (``sharding.py``'s convention): its rows' sum over the
    global count, divided by the size of every axis its rows are
    replicated over."""
    from ..sharding import axes_of, pmax, psum

    spec = ctx.spec_for(("batch", None, "act_model"), shape)
    rows, _, cols = ctx.block(spec, shape)
    vaxes, raxes = axes_of(spec[2]), axes_of(spec[0])
    labels, mask = labels[rows], mask[rows].float()
    logits = logits.float()
    vmax = pmax(torch.amax(logits, dim=-1, keepdim=True), ctx, vaxes,
                "loss")
    shifted = logits - vmax
    vocab = torch.arange(cols.start, cols.stop, device=logits.device)
    is_label = vocab == labels[..., None]
    both = psum(torch.stack([torch.sum(torch.exp(shifted), dim=-1),
                             torch.sum(torch.where(is_label, shifted, 0.0),
                                       dim=-1)], dim=-1), ctx, vaxes)
    nll = torch.log(both[..., 0]) - both[..., 1]
    local = torch.sum(nll * mask)
    with torch.no_grad():
        total, count = psum(torch.stack([local, torch.sum(mask)]), ctx,
                            raxes, "loss")
        count = torch.clamp(count, min=1.0)
    share = local / count / (ctx.size // ctx.axis_size(raxes))
    return _Seeded.apply(share, total / count)


def dense(x, w, b=None):
    y = einsum("...d,df->...f", x, w).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x (B, S, C), w (K, C).  With ``state``
    (B, K-1, C) given, performs a streaming step (S may be 1) and returns
    (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                            # (B, S+K-1, C)
    # windows: y[t] = sum_k w[k] * xp[t + k]
    S = x.shape[1]
    y = sum(xp[:, k: k + S, :] * w[k] for k in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else torch.zeros_like(pad)
    return y.to(x.dtype), new_state


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")

