"""AdamW on tensor trees with a warmup-cosine schedule, as the JAX
package's ``training/optimizer.py`` computes it.

The moments are float32 whatever the param dtype (bf16-safe).  The update
writes params and moments in place under ``torch.no_grad()``, the
counterpart of the reference's donated state.  In a world of ranks
(``sharding.world_context``) the params, gradients and moments are the
rank's blocks and AdamW is elementwise on them; only the global gradient
norm crosses ranks (``global_norm`` with the leaves' specs).  ``torch.optim.AdamW`` is not
used: it factors the bias corrections differently and decays 1-D leaves.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor; float32 result on its
    device): linear warmup, then cosine decay to ``min_lr_ratio``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def init_opt_state(params) -> dict:
    """Zero float32 moments shaped like ``params`` (on their devices) and a
    0-d int32 step count."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, ctx=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    In a world (``ctx``; ``specs`` the leaves' partition specs, the same
    tree) the leaves are this rank's blocks of the global ones: each rank
    sums a block only at coordinate 0 of every axis the leaf is
    replicated over, so each global element counts once, and one psum
    over the world adds the ranks' sums.  Every rank runs the same ops (a
    sum it does not count is clamped to 0, exactly), so each rank's step
    costs what rank 0's does."""
    if ctx is None or ctx.world is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    from ..sharding import psum

    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x, spec in zip(leaves, tree_leaves(specs)):
        counts = all(ctx.coordinate((a,)) == 0 for a in ctx.replicated(spec))
        total = total + torch.clamp(torch.sum(torch.square(x.float())),
                                    max=math.inf if counts else 0.0)
    return torch.sqrt(psum(total, ctx, tuple(ctx.mesh), "norm"))


@torch.no_grad()
def _update_leaf(p, g, m, v, *, scale, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf in the reference's order: clip, moments, bias-corrected
    step, decay on matrices, ``p - lr * step`` cast back to p's dtype.  Two
    leaf-sized float32 temporaries (``g`` becomes the step)."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * scale                      # a new tensor: ours to reuse
    m.mul_(b1).add_((1 - b1) * g)
    t = (1 - b2) * g
    v.mul_(b2).add_(t.mul_(g))
    torch.div(v, bc2, out=t)                   # vh
    t.sqrt_().add_(cfg.eps)
    torch.div(m, bc1, out=g)                   # mh
    g.div_(t)                                  # step = mh / (sqrt(vh) + eps)
    if p.ndim >= 2:                            # no decay on norms / biases
        g.add_(torch.mul(p.float(), cfg.weight_decay, out=t))
    g.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(g)
    else:
        p.copy_(p.float().sub_(g))


def adamw_update(grads, state: dict, params, cfg: AdamWConfig, ctx=None,
                 specs=None):
    """Returns (params, state, metrics): ``params`` and ``state``'s moments
    and count updated in place (the same objects come back); metrics
    ``grad_norm`` (before clipping) and ``lr`` as 0-d float32 tensors, the
    same on every rank of a world (``ctx`` and the leaves' ``specs``, as
    ``global_norm`` takes them)."""
    with torch.no_grad():
        count = state["count"].add_(1)
        lr = schedule(cfg, count)
        gnorm = global_norm(grads, ctx, specs)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        c = count.float()
        bc1 = 1 - cfg.beta1 ** c
        bc2 = 1 - cfg.beta2 ** c
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            _update_leaf(p, g, m, v, scale=scale, lr=lr, bc1=bc1, bc2=bc2,
                         cfg=cfg)
    return params, state, {"grad_norm": gnorm, "lr": lr}
