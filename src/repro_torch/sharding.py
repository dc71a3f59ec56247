"""Logical-axis sharding rules for params and activations, and the LM's
world of ranks.

Every parameter is declared with logical axis names
(``models/common.ParamSpec``); the rules map logical axes to mesh axes with
divisibility fallbacks, as the JAX package's ``sharding.py`` does, so the
specs a config gets on a mesh can be computed and held against the
reference's (``MeshContext.spec_for``).

A ``MeshContext`` holds a mesh's axis sizes (name -> size, ``launch/mesh.py``
``make_production_mesh`` / ``make_debug_mesh``) and, in a world of ranks,
the ``torch.distributed`` ``DeviceMesh`` over the same axes
(``world_context``; one process per rank, ``launch/mesh.py`` ``run_world``
/ ``launched_world`` with ``mesh_shape``).  In a world every array is the
rank's block of the global one, by ``spec_for``: ``local_block`` cuts a
block, ``gather_global`` puts the blocks back together, and the model
functions run on the blocks with explicit collectives (``core/dist_sort``).
A context whose axes are over 1 but that holds no world has no rank to run
on: the model functions raise ``NotImplementedError`` for it
(``require_one_device``) instead of running unsharded.

Gradients in a world.  ``psum``, ``all_gather`` and ``gather_spec`` (a
chain of ``all_gather`` s) are differentiable, and each collective's
backward is its transpose: a psum's backward is a psum of the incoming
gradients, a tiled all_gather's backward a reduce-scatter (a psum over the
axis, then this rank's block).  So autograd on every rank computes the
gradient of the sum over ranks of what each rank seeds its backward with,
and every activation gradient is the rank's partial share:

* the loss seeds each rank with its share (``models/common.py``
  ``world_cross_entropy``): the negative log-likelihood of its own rows
  over the global count, divided by the size of every axis over which
  those rows are replicated, so that the shares sum to the loss once;
* a leaf's gradient is then summed over exactly the axes along which
  ``spec_for`` replicates the leaf (``reduce_gradients``), which makes it
  this rank's block of the global gradient.

Megatron's identity-forward / psum-backward pairs are not used anywhere:
mixing the two conventions gives gradients off by a factor of the axis
size.  With grad mode off, or on a tensor that takes no gradient, each
collective is the plain call and records no graph (the serving path).
``TRAFFIC`` counts the LM's collective calls and their input bytes by kind
and by pass: the forward, its recomputation under remat (a call made while
autograd runs a backward) and the backward, and the loss's, the norm's and
the gradients' own reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

# logical axis -> preferred mesh axes (first that divides wins; None if none)
TRAIN_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "inner": ("model",),          # SSM / RG-LRU channel dim
    "fsdp": ("data",),            # ZeRO-3: shard weight d_model dims
    "expert_ff": ("pod",),        # expert hidden dim: extra FSDP over pods
    "q_lora": ("data",),
    "kv_lora": ("data",),
    "head_dim": (),
    "state": (),
    "conv": (),
    "layers": (),                 # scan axis stays replicated
    "batch": ("pod", "data"),
    "seq": (),
    "act_model": ("model",),      # activation head/mlp dims
}

# decode: FSDP off (weights must be resident), batch over (pod, data)
DECODE_RULES = dict(TRAIN_RULES, fsdp=())

@dataclasses.dataclass(frozen=True)
class MeshContext:
    """A mesh's axis sizes + the axis-name vocabulary the model code uses;
    in a world also the ``DeviceMesh`` (``world``, its dims named as the
    axes) and, while a model call is under way, the global batch of its
    activations (``batch``, which ``forward`` / ``decode_step`` set)."""

    mesh: Mapping[str, int]       # axis name -> size
    rules: Mapping[str, tuple[str, ...]]
    world: object = None          # torch DeviceMesh over the axes, or None
    batch: int | None = None      # global batch of the call under way

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.rules.get("batch", ()) if a in self.mesh)

    @property
    def model_axis(self) -> str | None:
        return "model" if "model" in self.mesh else None

    def axis_size(self, names: Sequence[str]) -> int:
        size = 1
        for n in names:
            size *= self.mesh.get(n, 1)
        return size

    def spec_for(self, logical_axes: Sequence[str | None],
                 dim_sizes: Sequence[int]) -> tuple:
        """Partition spec for one array (a tuple of mesh axis names, tuples
        of them, or None per dim), with divisibility fallback: a logical
        axis maps to its preferred mesh axes only if the dim divides evenly
        and the mesh axis is not already taken by an earlier dim."""
        used: set[str] = set()
        parts = []
        for ax, size in zip(logical_axes, dim_sizes):
            choice: tuple[str, ...] | None = None
            if ax is not None:
                prefs = tuple(a for a in self.rules.get(ax, ())
                              if a in self.mesh)
                # try the full tuple first (e.g. batch -> (pod, data)), then
                # single axes
                candidates = [prefs] + [(a,) for a in prefs]
                for cand in candidates:
                    if not cand or any(a in used for a in cand):
                        continue
                    total = self.axis_size(cand)
                    if total > 1 and size % total == 0:
                        choice = cand
                        break
            if choice:
                used.update(choice)
                parts.append(choice if len(choice) > 1 else choice[0])
            else:
                parts.append(None)
        return tuple(parts)

    # -- this rank's place in the world ------------------------------------

    def coordinate(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (0 off a world)."""
        idx = 0
        for a in axes:
            idx = idx * self.mesh[a] + (self.world.get_local_rank(a)
                                        if self.world is not None else 0)
        return idx

    def block(self, spec: Sequence, shape: Sequence[int]) -> tuple:
        """This rank's block of an array of global ``shape`` laid out by
        ``spec``: one slice per dim."""
        out = []
        for entry, size in zip(spec, shape):
            axes = axes_of(entry)
            n = size // self.axis_size(axes)
            i = self.coordinate(axes) if axes else 0
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    @property
    def size(self) -> int:
        """The number of ranks of the mesh."""
        return self.axis_size(tuple(self.mesh))

    def replicated(self, spec: Sequence) -> list[str]:
        """The axes of the world (of size over 1) along which an array laid
        out by ``spec`` is replicated: those no dim is split over."""
        used = {a for entry in spec for a in axes_of(entry)}
        return [a for a in _live(self, self.mesh) if a not in used]

    def local_shape(self, spec: Sequence, shape: Sequence[int]) -> tuple:
        return tuple(size // self.axis_size(axes_of(entry))
                     for entry, size in zip(spec, shape))

    def local_block(self, t, spec: Sequence):
        """This rank's block of the global tensor ``t`` (a view)."""
        return t[self.block(spec, t.shape)]

    def batch_of(self, x) -> int:
        """The global batch of the local activation ``x`` (its own first
        dim off a world)."""
        return x.shape[0] if self.batch is None else self.batch


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def world_context(world, rules=TRAIN_RULES) -> MeshContext:
    """The context of a world whose ``DeviceMesh`` is ``world``
    (``launch/mesh.py`` ``make_lm_mesh``)."""
    return MeshContext(dict(zip(world.mesh_dim_names, world.mesh.shape)),
                       rules, world)


def require_one_device(ctx: MeshContext) -> None:
    """Raise unless every axis of ``ctx`` has size 1 or ``ctx`` holds the
    world of ranks its axes describe."""
    if ctx.world is None and any(size > 1 for size in ctx.mesh.values()):
        raise NotImplementedError(
            f"mesh {dict(ctx.mesh)} with no world of ranks: model-parallel "
            f"LM serving runs one process per rank; pass a context of the "
            f"world (world_context(make_lm_mesh(...))), or one whose axes "
            f"all have size 1 (single_device_context())")


def constrain(x, ctx: MeshContext, logical_axes, shape=None):
    """The reference's sharding constraint.  On one device ``x`` itself.
    In a world ``x`` is this rank's block of an array of global ``shape``
    (default: ``x``'s own, i.e. nothing sharded): its shape must be the
    block ``spec_for`` gives, or this raises.  Moves no data."""
    require_one_device(ctx)
    if ctx.world is None:
        return x
    shape = tuple(x.shape) if shape is None else tuple(shape)
    want = ctx.local_shape(ctx.spec_for(logical_axes, shape), shape)
    if tuple(x.shape) != want:
        raise ValueError(
            f"a block of shape {tuple(x.shape)} where the layout "
            f"{ctx.spec_for(logical_axes, shape)} of {shape} over "
            f"{dict(ctx.mesh)} gives {want}")
    return x


# ---------------------------------------------------------------------------
# collectives over mesh axes (through core/dist_sort, which owns the
# transport); each is the identity off a world and over axes of size 1
# ---------------------------------------------------------------------------

# "kind/pass" -> [calls, input bytes] of this rank's LM collectives
TRAFFIC: dict[str, list[int]] = {}


def reset_traffic() -> None:
    TRAFFIC.clear()


def _note(kind: str, x, where: str | None = None) -> None:
    """One collective call of ``kind`` on ``x``: in the forward, in its
    recomputation (a forward call made while autograd runs a backward) or
    where ``where`` says."""
    if where is None:
        where = ("remat" if torch._C._current_graph_task_id() != -1
                 else "forward")
    rec = TRAFFIC.setdefault(f"{kind}/{where}", [0, 0])
    rec[0] += 1
    rec[1] += x.numel() * x.element_size()


def _live(ctx: MeshContext, axes: Sequence[str]) -> list[str]:
    if ctx.world is None:
        return []
    return [a for a in axes if ctx.mesh.get(a, 1) > 1]


def _differentiable(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Psum(torch.autograd.Function):
    """psum over one axis; its backward, the transpose, is a psum of the
    incoming gradients."""

    @staticmethod
    def forward(fctx, x, info):
        from .core import dist_sort as ds

        fctx.info = info
        return ds.psum(info, x)

    @staticmethod
    def backward(fctx, g):
        from .core import dist_sort as ds

        _note("psum", g, "backward")
        return ds.psum(fctx.info, g), None


class _AllGather(torch.autograd.Function):
    """Tiled all_gather over one axis; its backward, the transpose, is a
    reduce-scatter: the incoming gradients summed over the axis, this
    rank's block of the sum kept (a copy, so the sum is freed)."""

    @staticmethod
    def forward(fctx, x, info, dim: int):
        from .core import dist_sort as ds

        fctx.info, fctx.dim, fctx.n = info, dim, x.shape[dim]
        return ds.all_gather_tiled(info, x, dim)

    @staticmethod
    def backward(fctx, g):
        from .core import dist_sort as ds

        _note("reduce_scatter", g, "backward")
        total = ds.psum(fctx.info, g)
        me = ds._me(fctx.info)
        return total.narrow(fctx.dim, me * fctx.n, fctx.n).clone(), None, None


def psum(x, ctx: MeshContext, axes: Sequence[str] = ("model",),
         where: str | None = None):
    """The sum of ``x`` over the ranks along ``axes`` (differentiable: its
    backward is a psum).  ``where`` names the call in ``TRAFFIC`` (default:
    the forward or its recomputation)."""
    from .core import dist_sort as ds

    for a in _live(ctx, axes):
        info = ds.axis_info(ctx.world, a)
        _note("psum", x, where)
        x = _Psum.apply(x, info) if _differentiable(x) else ds.psum(info, x)
    return x


def pmax(x, ctx: MeshContext, axes: Sequence[str], where: str):
    """The max of ``x`` over the ranks along ``axes``; takes no
    gradient."""
    from .core import dist_sort as ds

    x = x.detach()
    for a in _live(ctx, axes):
        _note("pmax", x, where)
        x = ds.pmax(ds.axis_info(ctx.world, a), x)
    return x


def all_gather(x, ctx: MeshContext, axes: Sequence[str], dim: int):
    """The blocks of ``x`` along ``axes`` (a dim laid out over that tuple)
    concatenated on ``dim`` in global order (differentiable: its backward
    is a reduce-scatter)."""
    from .core import dist_sort as ds

    for a in reversed(_live(ctx, axes)):     # the minor axis first
        info = ds.axis_info(ctx.world, a)
        _note("all_gather", x)
        x = (_AllGather.apply(x, info, dim) if _differentiable(x)
             else ds.all_gather_tiled(info, x, dim))
    return x


def gather_spec(x, ctx: MeshContext, spec: Sequence, keep=()):
    """``x`` (a block laid out by ``spec``) with every dim gathered whole
    but those over the axes in ``keep`` (differentiable: the backward is
    the gathers' reduce-scatters in reverse order)."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if axes and not set(axes) <= set(keep):
            x = all_gather(x, ctx, axes, dim)
    return x


def reduce_gradients(grads, ctx: MeshContext, specs):
    """Each leaf's gradient (this rank's share, of a block laid out by its
    spec in ``specs``, the same tree) summed over the axes along which the
    leaf is replicated: this rank's block of the global gradient.  The
    leaves that share those axes (and a dtype) go in one flat buffer, one
    psum an axis.  The tree itself off a world."""
    from .models.common import tree_leaves, tree_map

    if ctx.world is None:
        return grads
    leaves = tree_leaves(grads)
    buckets: dict[tuple, list[int]] = {}
    for i, (g, spec) in enumerate(zip(leaves, tree_leaves(specs))):
        axes = tuple(ctx.replicated(spec))
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(i)
    out = {id(g): g for g in leaves}
    with torch.no_grad():
        for (axes, _), idx in buckets.items():
            flat = psum(torch.cat([leaves[i].reshape(-1) for i in idx]),
                        ctx, axes, "grads")
            parts = flat.split([leaves[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[id(leaves[i])] = part.view(leaves[i].shape)
    return tree_map(lambda g: out[id(g)], grads)


def gather_global(x, ctx: MeshContext, logical_axes, shape):
    """The global array of ``shape`` from every rank's block ``x``."""
    constrain(x, ctx, logical_axes, shape)
    return gather_spec(x, ctx, ctx.spec_for(logical_axes, shape))


def global_argmax(x, ctx: MeshContext, logical_axes, shape):
    """The argmax over the last dim of the global array of ``shape`` whose
    block is ``x`` (laid out by ``logical_axes``), ties to the lower index
    as ``jnp.argmax`` picks: the whole result (``shape[:-1]``) on every
    rank."""
    from .core import dist_sort as ds

    constrain(x, ctx, logical_axes, shape)
    spec = ctx.spec_for(logical_axes, shape)
    vaxes = _live(ctx, axes_of(spec[-1]))     # act_model: model alone
    if vaxes:
        ids = ds.argmax_sharded(ds.axis_info(ctx.world, vaxes[0]), x,
                                ctx.block(spec, shape)[-1].start)
    else:
        ids = torch.argmax(x, dim=-1)
    return gather_spec(ids, ctx, spec[:-1])


def single_device_context(rules=TRAIN_RULES) -> MeshContext:
    """1-device mesh with the production axis names."""
    return MeshContext({"pod": 1, "data": 1, "model": 1}, rules)
