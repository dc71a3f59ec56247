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

def _live(ctx: MeshContext, axes: Sequence[str]) -> list[str]:
    if ctx.world is None:
        return []
    return [a for a in axes if ctx.mesh.get(a, 1) > 1]


def psum(x, ctx: MeshContext, axes: Sequence[str] = ("model",)):
    """The sum of ``x`` over the ranks along ``axes``."""
    from .core import dist_sort as ds

    for a in _live(ctx, axes):
        x = ds.psum(ds.axis_info(ctx.world, a), x)
    return x


def all_gather(x, ctx: MeshContext, axes: Sequence[str], dim: int):
    """The blocks of ``x`` along ``axes`` (a dim laid out over that tuple)
    concatenated on ``dim`` in global order."""
    from .core import dist_sort as ds

    for a in reversed(_live(ctx, axes)):     # the minor axis first
        x = ds.all_gather_tiled(ds.axis_info(ctx.world, a), x, dim)
    return x


def gather_spec(x, ctx: MeshContext, spec: Sequence, keep=()):
    """``x`` (a block laid out by ``spec``) with every dim gathered whole
    but those over the axes in ``keep``."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if axes and not set(axes) <= set(keep):
            x = all_gather(x, ctx, axes, dim)
    return x


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
