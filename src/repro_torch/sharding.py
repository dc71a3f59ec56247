"""Logical-axis sharding rules for params and activations, on one card.

Every parameter is declared with logical axis names
(``models/common.ParamSpec``); the rules map logical axes to mesh axes with
divisibility fallbacks, as the JAX package's ``sharding.py`` does, so the
specs a config would get on the production mesh can be computed and held
against the reference's (``MeshContext.spec_for``).

Here a mesh is its axis sizes (name -> size, ``launch/mesh.py``
``make_production_mesh`` / ``make_debug_mesh``).  The port runs the LM on
one card: a model function given a context with an axis larger than 1
raises ``NotImplementedError`` (model-parallel LM serving over several
cards is a ROADMAP item) instead of running unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

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
    """A mesh's axis sizes + the axis-name vocabulary the model code uses."""

    mesh: Mapping[str, int]       # axis name -> size
    rules: Mapping[str, tuple[str, ...]]

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


def require_one_device(ctx: MeshContext) -> None:
    """Raise unless every axis of ``ctx`` has size 1."""
    if any(size > 1 for size in ctx.mesh.values()):
        raise NotImplementedError(
            f"mesh {dict(ctx.mesh)}: model-parallel LM serving over several "
            f"cards (ROADMAP.md, queue A) is not ported; pass a context "
            f"whose axes all have size 1 (single_device_context())")


def constrain(x, ctx: MeshContext, logical_axes):
    """The reference's sharding constraint: on one device, ``x`` itself."""
    require_one_device(ctx)
    return x


def single_device_context(rules=TRAIN_RULES) -> MeshContext:
    """1-device mesh with the production axis names."""
    return MeshContext({"pod": 1, "data": 1, "model": 1}, rules)
