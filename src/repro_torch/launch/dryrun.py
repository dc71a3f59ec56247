"""Dry run of every (architecture x input shape) cell on one H100: each LM
cell's step traced on ``meta`` at full width and depth for its memory and
roofline, and the bwt_index cells built and served for real; with
``--multi-pod``, every cell on the reference's production meshes (16x16
and 2x16x16), one rank's step traced in a world where no data moves.

The JAX package lowers and compiles each cell on 512 forced host devices
and reads XLA's memory and cost analyses; on one card the same proof is a
full-size step run on ``meta`` tensors under ``roofline.count``: it
allocates nothing and fails on any shape mismatch, and it counts the
step's matmul FLOPs, bytes and the high-water mark of the storage it
creates.  A cell's memory is its argument bytes (params, optimizer state,
batch, cache) plus that peak, against the card's ``HBM_BYTES``.

On a production mesh each rank is one card, and under ``spec_for`` every
rank's blocks have the same shapes (the divisibility fallback replicates
a dim, it never splits one unevenly; the MoE's capacity follows the
rank's own token count), so one rank's step is every rank's: rank 0 of
a ``launch/mesh.py`` ``meta_world`` of 256 or 512 ranks runs the world
step of the model code (the rank's blocks, every collective through
``core/dist_sort.py``, which moves nothing there) on ``meta``.  A mesh
cell records the rank's argument bytes (the reference's partition specs,
``specs.py``), the step's temp peak and whether the total fits one card,
its counts, its collectives by kind and pass (``sharding.TRAFFIC``) with
the bytes they move (``roofline.collective_bytes``), and the roofline
with its collective term over ``NVLINK_BW``.  The bwt_index cells run
there too, on the flat index mesh over the same 256 or 512 chips, as the
reference lowers them: rank 0 of a meta world traces the ISA build
(``dist_isa_local``: the q-gram init and every doubling round of the
budget, as the reference's ``lax.cond`` loop lowers them all; a real
text stops earlier) or one ``dist_count`` batch over its ``DistFMIndex``
shards, each kernel wrapper reporting the bytes its kernel would move
(``trace_index_mesh_cell``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all
    ... dryrun --arch qwen2p5_3b --shape train_4k
    ... dryrun --arch bwt_index            # build + serve on the card
    ... dryrun --multi-pod both --jobs 8   # the 16x16 and 2x16x16 meshes
    ... dryrun --arch bwt_index --multi-pod both   # the index cells there
    ... dryrun --list [--multi-pod both]
    ... dryrun --no-compile                # specs only, no trace

Results land in ``<out>/<arch>__<shape>__<mesh>.json`` (``h100x1`` for
one card, ``16x16`` / ``2x16x16``; default ``build/dryrun/``,
gitignored) and feed ``launch/report.py``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config
from ..models import transformer as tf
from .. import sharding
from ..models.common import tree_leaves, tree_map
from ..sharding import (
    DECODE_RULES,
    TRAIN_RULES,
    MeshContext,
    axes_of,
    reduce_gradients,
    single_device_context,
    world_context,
)
from ..training.optimizer import AdamWConfig, adamw_update
from . import roofline as rf
from .mesh import make_production_mesh, meta_world
from .specs import (
    SHAPES,
    batch_specs,
    cache_specs,
    local_nbytes,
    opt_state_abstract,
    param_specs_abstract,
    shape_skip_reason,
    tree_nbytes,
)

MESH = "h100x1"
CHIPS = 1
OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
INDEX_SHAPES = ("build", "serve")
# the reference's production meshes: name -> multi_pod, and the meshes
# each ``--multi-pod`` choice runs, in the reference's order
MESHES = {"16x16": False, "2x16x16": True}
MULTI_POD = {"single": ("16x16",), "multi": ("2x16x16",),
             "both": ("16x16", "2x16x16")}
# a traced build's rounds: every round of the budget, as the reference's
# lax.cond loop lowers them; a real text stops once no suffix is active
ROUNDS_NOTE = ("an upper bound: every round of the budget is traced; a "
               "real text stops at its psum'd flag")


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------

def _grad_fn(cfg, ctx, remat="full"):
    """(params, batch) -> (loss, grads): the loss gradient of one
    micro-batch by autograd, each stacked group rematerialised by
    ``remat``; grads in the params' dtype.  In a world the rank's block of
    the global gradient (``reduce_gradients`` over each leaf's replicated
    axes), as ``train_loop.make_train_step`` takes it."""
    specs = _world_specs(cfg, ctx)

    def grad(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss = tf.loss_fn(live, batch, cfg, ctx, remat_policy=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        return loss.detach(), reduce_gradients(
            tree_map(lambda t: by_leaf[id(t)], live), ctx, specs)

    return grad


def _world_specs(cfg, ctx):
    """The params' partition specs in a world (None off one)."""
    return tf.model_shardings(cfg, ctx) if ctx.world is not None else None


def _accumulate_fn(cfg, ctx, remat="full"):
    """(params, acc, batch) -> loss: one micro-batch's gradient added to
    the float32 accumulator ``acc`` in place."""
    grad = _grad_fn(cfg, ctx, remat)

    def micro(params, acc, batch):
        loss, grads = grad(params, batch)
        with torch.no_grad():
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g.float())
        return loss

    return micro


def _update_fn(n_micro: int, opt_cfg=AdamWConfig(), ctx=None, specs=None):
    """(params, opt, grads) -> None: the accumulated gradient's mean, then
    AdamW in place (in a world, ``ctx`` with the params' ``specs``, its
    norm a psum over the world)."""
    def update(params, opt, grads):
        with torch.no_grad():
            if n_micro > 1:
                for g in tree_leaves(grads):
                    g.div_(n_micro)
            adamw_update(grads, opt, params, opt_cfg, ctx, specs)

    return update


def _zeros32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _micro_slices(batch, n_micro: int):
    """The ``n_micro`` micro-batches of a batch (views along dim 0)."""
    return [{k: v.chunk(n_micro)[i] for k, v in batch.items()}
            for i in range(n_micro)]


def _train_step_fn(cfg, ctx, n_micro=1, remat="full"):
    """Train step with gradient accumulation over ``n_micro`` micro-batches
    (the fit lever for big models: activation checkpoints and CE temps
    scale with the micro-batch, grads accumulate in one float32 buffer),
    then AdamW: (state, batch) -> loss, the state updated in place."""
    grad = _grad_fn(cfg, ctx, remat)
    micro = _accumulate_fn(cfg, ctx, remat)
    update = _update_fn(n_micro)

    def step(state, batch):
        params = state["params"]
        if n_micro == 1:
            loss, grads = grad(params, batch)
        else:
            grads = _zeros32(params)
            loss = sum(micro(params, grads, mb)
                       for mb in _micro_slices(batch, n_micro)) / n_micro
        update(params, state["opt"], grads)
        return loss

    return step


def _prefill_fn(cfg, ctx):
    def prefill(params, batch):
        # serving prefill returns only the final position's logits — the
        # full (B, 32k, V) logits tensor was the biggest prefill temp
        with torch.no_grad():
            return tf.forward(params, batch, cfg, ctx, remat_policy="none",
                              last_token_only=True)

    return prefill


def _micro_batches(cfg, shape: str, chips: int) -> int:
    """Pick the gradient-accumulation factor so per-device activation
    checkpoints stay ~<= 4GB: layers x tokens_local x d_model x 2B."""
    if SHAPES[shape]["kind"] != "train":
        return 1
    B, S = SHAPES[shape]["global_batch"], SHAPES[shape]["seq_len"]
    dp = max(1, chips // 16)  # data(-and-pod) shards; model axis is 16
    tokens_local = (B // dp) * S
    ckpt_bytes = cfg.num_layers * tokens_local * cfg.d_model * 2
    target = 2 * 1024**3
    n = 1
    # each microbatch must still shard over all dp ranks: dp | (B / n)
    while ckpt_bytes / n > target and (B // (2 * n)) % dp == 0:
        n *= 2
    return n


def _decode_fn(cfg, ctx, max_len: int | None = None):
    def decode(params, cache, tokens, pos):
        with torch.no_grad():
            return tf.decode_step(params, cache, tokens, pos, cfg, ctx,
                                  max_len=max_len)

    return decode


def _with_groups(cfg, g: int):
    """Same prefix/suffix structure, ``g`` stacked groups."""
    prefix, pat, _groups, suffix = tf._layer_plan(cfg)
    return cfg.replace(
        num_layers=len(prefix) + g * len(pat) + len(suffix)
    )


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------

def mesh_axes(mesh) -> dict:
    """Axis sizes of a production mesh by name (``"16x16"``,
    ``"2x16x16"``), or ``mesh`` itself when it is already axis sizes."""
    if isinstance(mesh, str):
        return make_production_mesh(multi_pod=MESHES[mesh])
    return dict(mesh)


def _chips(axes: dict) -> int:
    n = 1
    for size in axes.values():
        n *= size
    return n


def cell_inputs(cfg, shape: str, *, rules=None, cache_dtype=None,
                global_batch: int | None = None, seq_len: int | None = None,
                mesh=None):
    """(ctx, kind, {name: Abstract}) of one cell on this card's mesh, or
    on the axis sizes ``mesh`` (the specs alone: a context that holds no
    world); ``global_batch`` / ``seq_len`` override the shape's."""
    kind = SHAPES[shape]["kind"]
    if rules is None:
        rules = TRAIN_RULES if kind == "train" else DECODE_RULES
    ctx = (single_device_context(rules) if mesh is None
           else MeshContext(mesh_axes(mesh), rules))
    params = param_specs_abstract(cfg, ctx, torch.bfloat16)
    args = {"params": params,
            "batch": batch_specs(cfg, shape, ctx, global_batch=global_batch,
                                 seq_len=seq_len)}
    if kind == "train":
        args["opt_state"] = opt_state_abstract(params, ctx)
    if kind == "decode":
        args["cache"] = cache_specs(cfg, shape, ctx, dtype=cache_dtype,
                                    global_batch=global_batch,
                                    seq_len=seq_len)
    return ctx, kind, args


@dataclasses.dataclass
class Traffic:
    """One rank's collectives over traced runs: the LM's calls and input
    bytes by "kind/pass" (``sharding.TRAFFIC``), and ``dist_sort``'s calls
    and [input, output] bytes by kind, what ``roofline.collective_bytes``
    turns into bytes moved."""

    by_pass: dict
    calls: dict
    nbytes: dict

    @classmethod
    def read(cls) -> "Traffic":
        from ..core import dist_sort

        return cls({k: list(v) for k, v in sharding.TRAFFIC.items()},
                   {k: v for k, v in dist_sort.COLLECTIVES.items() if v},
                   {k: list(v) for k, v in dist_sort.COLLECTIVE_BYTES.items()
                    if dist_sort.COLLECTIVES[k]})

    def scaled(self, k: int) -> "Traffic":
        """``k`` runs of the same calls."""
        def times(d):
            return {n: [x * k for x in v] if isinstance(v, list) else v * k
                    for n, v in d.items()}
        return Traffic(times(self.by_pass), times(self.calls),
                       times(self.nbytes))

    def __add__(self, other: "Traffic") -> "Traffic":
        def plus(a, b):
            out = {n: list(v) if isinstance(v, list) else v
                   for n, v in a.items()}
            for n, v in b.items():
                if n not in out:
                    out[n] = list(v) if isinstance(v, list) else v
                elif isinstance(v, list):
                    out[n] = [x + y for x, y in zip(out[n], v)]
                else:
                    out[n] += v
            return out
        return Traffic(plus(self.by_pass, other.by_pass),
                       plus(self.calls, other.calls),
                       plus(self.nbytes, other.nbytes))

    def records(self) -> list:
        """``roofline.collective_bytes`` records (one per kind)."""
        return [(k, c, *self.nbytes[k]) for k, c in self.calls.items()]


def _collecting(fn, *args):
    """``roofline.count`` of ``fn(*args)`` with this rank's collectives
    reset just before it and read just after: (result, Counts,
    Traffic)."""
    from ..core import dist_sort

    sharding.reset_traffic()
    dist_sort.reset_collectives()
    out, counts = rf.count(fn, *args)
    return out, counts, Traffic.read()


def _train_counts(cfg, ctx, params, opt, batch, n_micro: int, remat: str):
    """A train step's counts: one micro-batch traced and scaled by
    ``n_micro`` (every micro-batch runs the same ops), AdamW traced once;
    the temp peak is the float32 accumulator plus the larger of the two
    traces' peaks (one micro-batch's, the update's), or with one
    micro-batch the larger of the micro-batch's and the update's with the
    gradients alive through it.  Returns (counts, micro, update,
    traffic)."""
    specs = _world_specs(cfg, ctx)
    mb = _micro_slices(batch, n_micro)[0]
    if n_micro == 1:
        (_, grads), micro, t_micro = _collecting(_grad_fn(cfg, ctx, remat),
                                                 params, mb)
        _, update, t_update = _collecting(
            _update_fn(1, ctx=ctx, specs=specs), params, opt, grads)
        # the grads are the update's argument, alive through it
        update.peak_bytes += tree_nbytes(grads)
        counts = micro + update
        traffic = t_micro + t_update
    else:
        acc, init, _ = _collecting(_zeros32, params)
        _, micro, t_micro = _collecting(_accumulate_fn(cfg, ctx, remat),
                                        params, acc, mb)
        _, update, t_update = _collecting(
            _update_fn(n_micro, ctx=ctx, specs=specs), params, opt, acc)
        counts = init + micro.scaled(n_micro) + update
        counts.peak_bytes = tree_nbytes(acc) + max(micro.peak_bytes,
                                                   update.peak_bytes)
        traffic = t_micro.scaled(n_micro) + t_update
    return counts, micro, update, traffic


def rank_step(cfg, kind: str, ctx, inputs: dict, *, remat: str = "full",
              n_micro: int = 1, pos: int = 0,
              max_len: int | None = None) -> tuple:
    """One rank's step of a cell of ``kind`` on ``ctx`` under
    ``roofline.count``: a meta world's rank on ``meta`` tensors, or a real
    world's (or one device's) on tensors with storage, at any size.
    ``inputs``: the rank's ``params`` (and ``opt_state`` to train, its
    ``cache`` to decode, in the reference's layout) and the global
    ``batch``.  The step is the world step of the model code: train is
    ``loss_fn`` with autograd under ``remat``, ``reduce_gradients`` and
    AdamW with its norm's psum (``n_micro`` micro-batches accumulated);
    prefill ``forward(last_token_only=True)``; decode ``decode_step`` at
    ``pos`` (``max_len`` its cache's length).  Returns (Counts, Traffic,
    {"micro_batch", "update"} counts of a train step)."""
    params, batch = inputs["params"], inputs["batch"]
    if kind == "train":
        counts, micro, update, traffic = _train_counts(
            cfg, ctx, params, inputs["opt_state"], batch, n_micro, remat)
        return counts, traffic, {"micro_batch": micro.to_dict(),
                                 "update": update.to_dict()}
    if kind == "prefill":
        _, counts, traffic = _collecting(_prefill_fn(cfg, ctx), params,
                                         batch)
    else:
        _, counts, traffic = _collecting(_decode_fn(cfg, ctx, max_len),
                                         params, inputs["cache"],
                                         batch["tokens"], pos)
    return counts, traffic, {}


def _blocks(abstract, dtype=None) -> dict:
    """``meta`` tensors of the rank's blocks of an Abstract's leaves (in
    ``dtype``, or each leaf's own)."""
    return tree_map(lambda t, shape: torch.empty(
        shape, dtype=dtype or t.dtype, device="meta"),
        abstract.tree, abstract.local)


def rank_inputs(cfg, kind: str, ctx, args: dict, *, B: int, S: int,
                dtype=torch.bfloat16, cache_dtype=None) -> dict:
    """One rank's inputs of a step on ``ctx``'s world, on ``meta``: the
    params (in ``dtype``) and AdamW state as the rank's blocks of
    ``args`` (``cell_inputs``), the global batch (the step reads its
    rows), and the decode cache as ``init_cache`` lays it out in the
    world (``ctx``): the reference's layout, the attention caches'
    sequence over model (``sharding.cache_spec``)."""
    inputs = {"params": _blocks(args["params"], dtype),
              "batch": args["batch"].tree}
    if kind == "train":
        inputs["opt_state"] = _blocks(args["opt_state"])
    if kind == "decode":
        inputs["cache"] = tf.init_cache(cfg, B, S,
                                        cache_dtype or torch.bfloat16,
                                        device="meta", ctx=ctx)
    return inputs


ATTENTION_CACHE = ("k", "v", "ckv", "k_rope")


def attention_cache_nbytes(cache, local=None) -> int:
    """Bytes of a decode cache's attention leaves (``ATTENTION_CACHE``):
    of each leaf itself, or of its per-device shape in ``local`` (an
    ``Abstract``'s tree of shapes of the same structure)."""
    if isinstance(cache, dict):
        items = cache.items()
    elif isinstance(cache, list):
        items = enumerate(cache)
    else:
        return 0
    total = 0
    for k, v in items:
        shape = None if local is None else local[k]
        if k in ATTENTION_CACHE and isinstance(v, torch.Tensor):
            total += int(np.prod(v.shape if shape is None else shape)
                         ) * v.element_size()
        else:
            total += attention_cache_nbytes(v, shape)
    return total


def split_axes(cfg, ctx) -> list:
    """The mesh axes of size over 1 that the rules split some weight
    over (each needs a collective in the step)."""
    used = {a for spec in tree_leaves(tf.model_shardings(cfg, ctx))
            for entry in spec for a in axes_of(entry)}
    return sorted(a for a in used if ctx.mesh.get(a, 1) > 1)


def trace_cell(cfg, shape: str, *, mesh=None, rank: int = 0, rules=None,
               remat: str = "full", n_micro: int | None = None,
               cache_dtype=None, global_batch: int | None = None) -> dict:
    """One LM cell's step on ``meta`` under ``roofline.count``: its memory
    (argument bytes by kind, the step's peak temp bytes, their total and
    whether it fits ``HBM_BYTES``) and its counts.  The keyword overrides
    (rules / remat / n_micro / cache_dtype / global_batch) are perf's
    variant levers.

    With ``mesh`` (``"16x16"``, ``"2x16x16"`` or axis sizes) the step is
    rank ``rank``'s on that mesh, in a meta world (``trace_mesh_cell``).

    A train step traces one micro-batch and scales its counts by
    ``n_micro`` (every micro-batch runs the same ops), then traces AdamW
    once; its temp peak is the float32 accumulator plus the larger of the
    two traces' peaks (one micro-batch's, the update's)."""
    if mesh is not None:
        return trace_mesh_cell(cfg, shape, mesh, rank=rank, rules=rules,
                               remat=remat, n_micro=n_micro,
                               cache_dtype=cache_dtype,
                               global_batch=global_batch)
    ctx, kind, args = cell_inputs(cfg, shape, rules=rules,
                                  cache_dtype=cache_dtype,
                                  global_batch=global_batch)
    B = global_batch or SHAPES[shape]["global_batch"]
    params = args["params"].tree
    t0 = time.perf_counter()
    rec = {"argument_bytes": {k: tree_nbytes(v.tree)
                              for k, v in args.items()}}
    if kind == "train":
        rule = _micro_batches(cfg, shape, CHIPS)
        n_micro = min(rule, B) if n_micro is None else n_micro
        rec.update(n_micro=n_micro, n_micro_rule=rule)
        counts, micro, update, _ = _train_counts(
            cfg, ctx, params, args["opt_state"].tree, args["batch"].tree,
            n_micro, remat)
        rec["micro_batch"] = micro.to_dict()
        rec["update"] = update.to_dict()
        tokens = B * SHAPES[shape]["seq_len"]
    elif kind == "prefill":
        _, counts = rf.count(_prefill_fn(cfg, ctx), params,
                             args["batch"].tree)
        tokens = B * SHAPES[shape]["seq_len"]
    else:
        _, counts = rf.count(_decode_fn(cfg, ctx), params,
                             args["cache"].tree, args["batch"].tree["tokens"],
                             SHAPES[shape]["seq_len"] - 1)
        tokens = B
    rec["trace_s"] = time.perf_counter() - t0
    arg = sum(rec["argument_bytes"].values())
    rec["memory"] = _memory(arg, counts.peak_bytes)
    rec["counts"] = counts.to_dict()
    roof = rf.Roofline(counts.flops, counts.bytes, 0.0, {}, CHIPS,
                       counts.dtype)
    rec["roofline"] = roof.to_dict()
    rec["tokens"] = tokens
    return rec


def _memory(arg: int, temp: int) -> dict:
    return {"argument_size_in_bytes": arg, "temp_size_in_bytes": temp,
            "total_bytes": arg + temp, "hbm_bytes": rf.HBM_BYTES,
            "fits": arg + temp <= rf.HBM_BYTES}


def trace_mesh_cell(cfg, shape: str, mesh, *, rank: int = 0, rules=None,
                    remat: str = "full", n_micro: int | None = None,
                    cache_dtype=None, global_batch: int | None = None,
                    seq_len: int | None = None,
                    dtype=torch.bfloat16) -> dict:
    """Rank ``rank``'s step of one LM cell on ``mesh`` (a production mesh
    by name, or axis sizes), traced on ``meta`` in a ``meta_world`` of the
    mesh's ranks (``rank_step``; ``n_micro`` by default the reference's
    ``_micro_batches`` at the mesh's chip count).

    ``argument_bytes`` are the rank's blocks by the reference's partition
    specs (``specs.py``); ``held_argument_bytes`` what the port's step
    holds (``rank_inputs``), and for a decode cell
    ``attention_cache_bytes`` the attention leaves' part of each: equal,
    the world's cache in the reference's layout (its SSM / RG-LRU states
    may differ by a few KB, the Mamba-2 conv window's channels); the
    memory adds the step's temp peak to the held bytes.  The collectives are this rank's, by kind and pass, with the
    bytes they move; the roofline's collective term is those bytes over
    ``NVLINK_BW``."""
    axes = mesh_axes(mesh)
    chips = _chips(axes)
    kind = SHAPES[shape]["kind"]
    if rules is None:
        rules = TRAIN_RULES if kind == "train" else DECODE_RULES
    B = global_batch or SHAPES[shape]["global_batch"]
    S = seq_len or SHAPES[shape]["seq_len"]
    _, _, args = cell_inputs(cfg, shape, rules=rules, cache_dtype=cache_dtype,
                             global_batch=B, seq_len=S, mesh=axes)
    rec = {"mesh": mesh if isinstance(mesh, str) else axes, "chips": chips,
           "rank": rank,
           "argument_bytes": {k: local_nbytes(v) for k, v in args.items()}}
    if kind == "train":
        rule = _micro_batches(cfg, shape, chips)
        n_micro = min(rule, B) if n_micro is None else n_micro
        rec.update(n_micro=n_micro, n_micro_rule=rule)
    t0 = time.perf_counter()
    with meta_world(axes, rank) as world:
        ctx = world_context(world, rules)
        inputs = rank_inputs(cfg, kind, ctx, args, B=B, S=S, dtype=dtype,
                             cache_dtype=cache_dtype)
        counts, traffic, parts = rank_step(cfg, kind, ctx, inputs,
                                           remat=remat, n_micro=n_micro or 1,
                                           pos=S - 1, max_len=S)
        rec["split_axes"] = split_axes(cfg, ctx)
        held = {k: tree_nbytes(v) for k, v in inputs.items()}
        if kind == "decode":
            rec["attention_cache_bytes"] = {
                "argument": attention_cache_nbytes(args["cache"].tree,
                                                   args["cache"].local),
                "held": attention_cache_nbytes(inputs["cache"])}
    rec["trace_s"] = time.perf_counter() - t0
    held["batch"] = rec["argument_bytes"]["batch"]     # the rank's rows
    rec["held_argument_bytes"] = held
    rec.update(parts)
    rec["memory"] = _memory(sum(held.values()), counts.peak_bytes)
    rec["counts"] = counts.to_dict()
    stats = rf.collective_bytes(traffic.records())
    rec["collectives"] = {"by_pass": traffic.by_pass, "calls": traffic.calls,
                          "bytes": traffic.nbytes,
                          "moved": stats.bytes_by_op,
                          "moved_bytes": stats.total_bytes}
    roof = rf.Roofline(counts.flops, counts.bytes, stats.total_bytes,
                       {"counts": stats.counts, "bytes": stats.bytes_by_op},
                       chips, counts.dtype)
    rec["roofline"] = roof.to_dict()
    rec["tokens"] = B * S if kind in ("train", "prefill") else B
    return rec


def run_cell(arch: str, shape: str, *, mesh: str = MESH,
             compile_: bool = True, config_of=get_config) -> dict:
    """One LM cell on one card (``mesh`` ``MESH``) or on a production
    mesh: skipped for the reference's reason, its specs only
    (``compile_=False``), or traced (``trace_cell``)."""
    cfg = config_of(arch)
    on_card = mesh == MESH
    chips = CHIPS if on_card else _chips(mesh_axes(mesh))
    base = {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
            "kind": SHAPES[shape]["kind"]}
    reason = shape_skip_reason(cfg, shape)
    if reason:
        return dict(base, status="skipped", reason=reason)
    if not compile_:
        _, _, args = cell_inputs(cfg, shape,
                                 mesh=None if on_card else mesh)
        return dict(base, status="specs", argument_bytes={
            k: local_nbytes(v) for k, v in args.items()})
    return with_model_flops(dict(
        base, status="traced",
        **trace_cell(cfg, shape, mesh=None if on_card else mesh)), cfg)


def with_model_flops(rec: dict, cfg) -> dict:
    """A traced record with its model FLOPs and their share of the FLOPs
    its chips count (``useful_flops_ratio``)."""
    mf = rf.model_flops(cfg, rec["tokens"])
    rec["model_flops"] = mf
    rec["roofline"]["model_flops"] = mf
    hw = rec["roofline"]["flops_per_device"] * rec["roofline"]["chips"]
    rec["roofline"]["useful_flops_ratio"] = mf / hw if hw else None
    return rec


# --------------------------------------------------------------------------
# bwt_index cells on a production mesh: one rank traced on meta
# --------------------------------------------------------------------------

def index_parts(mesh) -> int:
    """The parts of the flat index mesh over a production mesh's chips
    (``"16x16"``: 256, ``"2x16x16"``: 512), or ``mesh`` itself when it is
    already a count of parts."""
    return mesh if isinstance(mesh, int) else _chips(mesh_axes(mesh))


def index_mesh_specs(shape: str, parts: int, icfg) -> dict:
    """The reference's arguments of a bwt_index cell on a flat mesh of
    ``parts`` (``launch/dryrun.py`` ``lower_index_cell``): name ->
    (global shape, dtype, one rank's shape).  The build takes the text
    ``s`` int32[n] over parts; serve the BWT int32[n] and the Occ
    checkpoints int32[n/r, sigma] over parts, the C array, the unpacked
    layout's (1, 1) fused placeholder and the patterns, replicated."""
    n, r, sigma = icfg.n, icfg.sample_rate, icfg.sigma
    split = {"s": (n,), "bwt": (n,), "occ_samples": (n // r, sigma)}
    whole = {"c_array": (sigma,), "fused": (1, 1),
             "patterns": (icfg.query_batch, icfg.query_len)}
    names = (("s",) if shape == "build" else
             ("bwt", "occ_samples", "c_array", "fused", "patterns"))
    return {k: (split[k], torch.int32, (split[k][0] // parts,
                                        *split[k][1:]))
            if k in split else (whole[k], torch.int32, whole[k])
            for k in names}


def index_argument_bytes(shape: str, parts: int, icfg) -> dict:
    """One rank's bytes of each of the reference's arguments."""
    return {k: int(np.prod(local)) * dtype.itemsize
            for k, (_, dtype, local) in index_mesh_specs(shape, parts,
                                                         icfg).items()}


def index_rank_inputs(shape: str, parts: int, icfg) -> dict:
    """One rank's inputs of a bwt_index cell on ``meta``: the text shard,
    or the rank's ``DistFMIndex`` (its BWT shard and Occ checkpoints, the
    C array and the row; the unpacked layout, as the reference's
    ``bits = 0``; no SA sample: count only) and the replicated
    patterns."""
    from ..core.dist_fm import DistFMIndex

    arg = {k: torch.empty(local, dtype=dtype, device="meta")
           for k, (_, dtype, local) in index_mesh_specs(shape, parts,
                                                        icfg).items()}
    if shape == "build":
        return arg
    index = DistFMIndex(
        bwt=arg["bwt"], occ_samples=arg["occ_samples"],
        c_array=arg["c_array"],
        row=torch.empty((), dtype=torch.int32, device="meta"), fused=None,
        sa_marks=None, sa_mark_ranks=None, sa_vals=None,
        sample_rate=icfg.sample_rate, sigma=icfg.sigma, length=icfg.n,
        parts=parts, bits=0, sa_sample_rate=0)
    return {"index": index, "patterns": arg["patterns"]}


def index_sa_config(icfg):
    """The mesh build's ``DistSAConfig`` of ``icfg`` with its local sort
    resolved for the card an estimate is for (``"auto"``: the radix
    kernels), not for the ``meta`` tensors it is traced on."""
    from ..core.pipeline import mesh_sa_config
    from ..kernels.ops import resolve_sort_engine

    cfg = mesh_sa_config(icfg)
    return cfg._replace(local_sort=resolve_sort_engine(cfg.local_sort,
                                                       "cuda"))


def trace_index_mesh_cell(shape: str, mesh, icfg=None) -> dict:
    """Rank 0's step of the bwt_index ``shape`` cell (``"build"`` or
    ``"serve"``) on the flat index mesh over ``mesh``'s chips (a
    production mesh by name, or a count of parts), traced on ``meta``
    under ``roofline.count`` in a ``meta_world`` of that many ranks, the
    estimate for one card: ``build`` is ``dist_isa_local`` over
    the text shard, the ISA the reference's ``_isa_jit`` lowers (local
    sorts by ``index_sa_config``); ``serve`` is one ``dist_count`` batch.

    Returns the record fields of ``trace_mesh_cell``: ``argument_bytes``
    by the reference's specs (``index_mesh_specs``),
    ``held_argument_bytes`` what the port's rank holds (serve: its
    ``DistFMIndex`` arrays, which hold the row where the reference holds
    a fused placeholder), the memory with the step's temp peak, the
    counts, the collectives by kind with the bytes they move and the
    roofline with its collective term; and ``rounds_traced``, the build's
    rounds (``ROUNDS_NOTE``)."""
    from ..configs.bwt_index import CONFIG
    from ..core.dist_fm import dist_count
    from ..core.dist_sort import AXIS, _capacity, shard_info
    from ..core.dist_suffix_array import dist_isa_local
    from .mesh import meta_world

    icfg = icfg or CONFIG
    parts = index_parts(mesh)
    cfg = index_sa_config(icfg)
    rec = {"mesh": mesh, "chips": parts, "rank": 0, "parts": parts,
           "n": icfg.n, "part_size": icfg.n // parts, "sigma": icfg.sigma,
           "argument_bytes": index_argument_bytes(shape, parts, icfg)}
    inputs, stats = index_rank_inputs(shape, parts, icfg), {}
    t0 = time.perf_counter()
    with meta_world({AXIS: parts}, 0) as world:
        info = shard_info(world, icfg.n)
        if shape == "build":
            _, counts, traffic = _collecting(
                lambda s: dist_isa_local(info, cfg, s, icfg.sigma,
                                         stats=stats), inputs["s"])
        else:
            _, counts, traffic = _collecting(dist_count, inputs["index"],
                                             inputs["patterns"], world)
    rec["trace_s"] = time.perf_counter() - t0
    if shape == "build":
        rec["held_argument_bytes"] = {"s": inputs["s"].nbytes}
        rec.update(engine=cfg.engine, capacity_factor=cfg.capacity_factor,
                   local_sort=cfg.local_sort, h0=stats["h0"],
                   rounds_traced=len(stats["round_s"]),
                   rounds_note=ROUNDS_NOTE,
                   bucket_capacity=_capacity(info, cfg.capacity_factor))
        rec["tokens"] = icfg.n
    else:
        index = inputs["index"]
        rec["held_argument_bytes"] = {
            "bwt": index.bwt.nbytes, "occ_samples": index.occ_samples.nbytes,
            "c_array": index.c_array.nbytes, "row": index.row.nbytes,
            "patterns": inputs["patterns"].nbytes}
        rec.update(query_batch=icfg.query_batch, query_len=icfg.query_len)
        rec["tokens"] = icfg.query_batch
    rec["memory"] = _memory(sum(rec["held_argument_bytes"].values()),
                            counts.peak_bytes)
    rec["counts"] = counts.to_dict()
    stats_c = rf.collective_bytes(traffic.records())
    rec["collectives"] = {"calls": traffic.calls, "bytes": traffic.nbytes,
                          "moved": stats_c.bytes_by_op,
                          "moved_bytes": stats_c.total_bytes}
    roof = rf.Roofline(counts.flops, counts.bytes, stats_c.total_bytes,
                       {"counts": stats_c.counts,
                        "bytes": stats_c.bytes_by_op}, parts, counts.dtype)
    rec["roofline"] = roof.to_dict()
    return rec


def run_index_mesh_cell(shape: str, mesh: str, *, compile_: bool = True,
                        icfg=None) -> dict:
    """A bwt_index cell on a production mesh: its specs only
    (``compile_=False``), or traced for rank 0 (``trace_index_mesh_cell``)."""
    from ..configs.bwt_index import CONFIG

    icfg = icfg or CONFIG
    parts = index_parts(mesh)
    base = {"arch": "bwt_index", "shape": shape, "mesh": mesh,
            "chips": parts, "kind": shape}
    if not compile_:
        return dict(base, status="specs", argument_bytes=index_argument_bytes(
            shape, parts, icfg))
    return dict(base, status="traced", **trace_index_mesh_cell(shape, mesh,
                                                                icfg))


# --------------------------------------------------------------------------
# bwt_index cells: built and served for real
# --------------------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(device) -> int:
    """Start a peak-memory window on the card; returns the bytes already
    allocated (0 on the CPU)."""
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(device, base: int):
    """The window's peak allocated bytes above ``base`` (None on the
    CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() - base


def index_patterns(tokens: np.ndarray, batch: int, length: int,
                   seed: int = 0) -> np.ndarray:
    """``batch`` substrings of ``length`` tokens drawn from the text (each
    occurs at least once)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(tokens) - length, batch)
    return np.stack([tokens[s: s + length] for s in starts]).astype(np.int32)


def index_build(tokens, mesh, icfg, device):
    """``build_index(tokens, mesh)`` with the config's engine, capacity
    factor, rounds and sigma."""
    from ..core.pipeline import build_index, mesh_sa_config

    return build_index(tokens, mesh, sample_rate=icfg.sample_rate,
                       sa_sample_rate=icfg.sa_sample_rate,
                       sa_config=mesh_sa_config(icfg), sigma=icfg.sigma,
                       device=device)


def _index_record(shape, counts, seconds, peak, launches, records, n,
                  **extra):
    stats = rf.collective_bytes(records)
    roof = rf.Roofline(counts.flops, counts.bytes, stats.total_bytes,
                       {"counts": stats.counts, "bytes": stats.bytes_by_op},
                       CHIPS)
    return {"arch": "bwt_index", "shape": shape, "mesh": MESH,
            "chips": CHIPS, "kind": shape, "status": "measured",
            "tokens": n, "seconds": seconds, "peak_bytes": peak,
            "counts": counts.to_dict(), "roofline": roof.to_dict(),
            "collectives": {k: c for k, c, _, _ in records},
            "launches": launches, **extra}


def _counted(fn, *args, device):
    """``fn(*args)`` under ``roofline.count`` with the launch counts and
    collectives reset just before it and read just after: (result,
    counts, peak device bytes, launches, collective records)."""
    from ..core import dist_sort
    from ..kernels import _build

    dist_sort.reset_collectives()
    _build.reset_launches()
    base = _reset_peak(device)
    out, counts = rf.count(fn, *args)
    _sync(device)
    return out, counts, _peak(device, base), dict(_build.LAUNCHES), \
        rf.dist_records()


def _timed(fn, *args, device) -> float:
    t0 = time.perf_counter()
    fn(*args)
    _sync(device)
    return time.perf_counter() - t0


def run_index_cells(shapes, mesh, *, icfg=None, device=None, tokens=None,
                    on_build=None) -> list:
    """The bwt_index cells on a one-part ``mesh``: ``build`` runs
    ``build_index(tokens, mesh)`` over the english corpus at the config's
    n (``tokens``, when the caller has made them) once under
    ``roofline.count`` (launch counts reset just before it, read just
    after; ``on_build``, when given, is then called with the index), then
    once more timed alone; ``serve`` counts one ``dist_count`` batch of
    ``query_batch`` x ``query_len`` substrings of the text, then times a
    second.  Each records seconds, peak memory, the counts (the kernels'
    reported bytes in them), collective bytes by kind and the roofline."""
    from ..configs.bwt_index import CONFIG
    from ..data.corpus import corpus
    from ..devices import resolve_device

    icfg = icfg or CONFIG
    device = resolve_device(device)
    t0 = time.perf_counter()
    if tokens is None:
        tokens = corpus("english", icfg.n)
    gen_s = time.perf_counter() - t0
    out, index = [], None
    if "build" in shapes or "serve" in shapes:
        index, counts, peak, launches, records = _counted(
            index_build, tokens, mesh, icfg, device, device=device)
        if on_build is not None:
            on_build(index)
        seconds = _timed(index_build, tokens, mesh, icfg, device,
                         device=device)
        if "build" in shapes:
            out.append(_index_record(
                "build", counts, seconds, peak, launches, records, icfg.n,
                corpus="english", sigma=icfg.sigma, engine=icfg.engine,
                capacity_factor=icfg.capacity_factor, rounds=icfg.rounds,
                corpus_s=gen_s, text_sigma=int(index.sigma)))
    if "serve" in shapes:
        pats = torch.as_tensor(index_patterns(tokens, icfg.query_batch,
                                              icfg.query_len), device=device)
        hits, counts, peak, launches, records = _counted(
            index.count, pats, device=device)
        seconds = _timed(index.count, pats, device=device)
        if int(hits.min()) < 1:
            raise AssertionError("bwt_index serve: a substring of the text "
                                 "counted 0")
        out.append(_index_record(
            "serve", counts, seconds, peak, launches, records,
            icfg.query_batch, query_len=icfg.query_len,
            total_hits=int(hits.sum())))
    return out


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def save_result(res: dict, out_dir) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{res['arch']}__{res['shape']}__{res['mesh']}.json"
    with open(out_dir / name, "w") as f:
        json.dump(res, f, indent=2, default=str)


def cell_record(cell, compile_, config_of, index_cfg=None):
    """One cell (arch, shape, mesh) in a pool worker: the record, or the
    failure's.  A bwt_index cell on a production mesh is traced for one
    rank (``run_index_mesh_cell``, of ``index_cfg``)."""
    arch, shape, mesh = cell
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        if arch == "bwt_index":
            return run_index_mesh_cell(shape, mesh, compile_=compile_,
                                       icfg=index_cfg)
        return run_cell(arch, shape, mesh=mesh, compile_=compile_,
                        config_of=config_of)
    except Exception:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "failed", "error": traceback.format_exc(),
                "trace_s": time.perf_counter() - t0}


def cells_of(arch: str = "all", shape: str = "all", meshes=(MESH,)) -> list:
    """(arch, shape, mesh) cells in the reference's order: each config's
    shapes, each on every mesh of ``meshes``."""
    lm_archs = [a for a in ARCH_IDS if a != "bwt_index"]
    archs = lm_archs + ["bwt_index"] if arch == "all" else [arch]
    cells = []
    for a in archs:
        shapes = (list(INDEX_SHAPES) if a == "bwt_index"
                  else (list(SHAPES) if shape == "all" else [shape]))
        cells += [(a, s, m) for s in shapes for m in meshes]
    return cells


def run_cells(cells, *, compile_: bool = True, jobs: int = 1,
              config_of=get_config, index_cfg=None) -> list:
    """The cells' records (LM cells, and bwt_index cells on production
    meshes), in ``jobs`` spawned processes when over one (each mesh
    cell's meta world opens in the process that traces it)."""
    if jobs > 1 and len(cells) > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(jobs,
                                                    mp_context=ctx) as pool:
            return list(pool.map(cell_record, cells,
                                 [compile_] * len(cells),
                                 [config_of] * len(cells),
                                 [index_cfg] * len(cells)))
    threads = torch.get_num_threads()
    try:
        return [cell_record(c, compile_, config_of, index_cfg)
                for c in cells]
    finally:
        torch.set_num_threads(threads)


def main(argv=None, *, config_of=get_config, index_cfg=None,
         index_device=None, index_mesh=None, index_tokens=None,
         on_index_build=None) -> list:
    """Run the cells the arguments name and write one JSON each; returns
    the records.  Raises ``SystemExit(1)`` after the last cell when any
    cell failed.  The keyword arguments are for rehearsals: other LM
    configs (``get_reduced_config``), another index config and device,
    and an index mesh to run in (default: a one-rank world of its own,
    NCCL on the card).  ``index_cfg`` applies to the mesh cells too;
    ``index_tokens`` / ``on_index_build`` are ``run_index_cells``'
    ``tokens`` / ``on_build``.

    Without ``--multi-pod`` every cell runs on one card; with it, on the
    reference's production meshes (``single``: 16x16, ``multi``: 2x16x16,
    ``both``), every cell traced for rank 0 in a meta world of its own,
    in the same ``--jobs`` processes: the LM cells' steps, and the
    bwt_index cells' ISA build and ``dist_count`` batch on the flat index
    mesh over the same chips (``trace_index_mesh_cell``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=sorted(MULTI_POD), default=None,
                    help="the reference's production meshes instead of "
                         "one card")
    ap.add_argument("--no-compile", action="store_true",
                    help="specs only, no trace (and no index cell)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="LM cells traced in parallel processes")
    args = ap.parse_args(argv)

    meshes = MULTI_POD[args.multi_pod] if args.multi_pod else (MESH,)
    cells = cells_of(args.arch, args.shape, meshes)
    if args.list:
        for arch, shape, mesh in cells:
            # the reference lists (arch, shape, multi_pod)
            print((arch, shape, MESHES[mesh] if args.multi_pod else mesh))
        return []

    traced = [c for c in cells if c[0] != "bwt_index" or args.multi_pod]
    index = [(s, m) for a, s, m in cells
             if a == "bwt_index" and not args.multi_pod]
    results = run_cells(traced, compile_=not args.no_compile, jobs=args.jobs,
                        config_of=config_of, index_cfg=index_cfg)
    for res in results:
        _emit(res, args.out)
    if index and not args.no_compile:
        for res in _index_cells([s for s, _ in index], index_cfg,
                                index_device, index_mesh,
                                tokens=index_tokens,
                                on_build=on_index_build):
            _emit(res, args.out)
            results.append(res)
    failures = sum(res["status"] == "failed" for res in results)
    print(f"done, {failures} failures", flush=True)
    if failures:
        raise SystemExit(1)
    return results


def _emit(res: dict, out_dir) -> None:
    save_result(res, out_dir)
    r = res.get("roofline", {})
    mem = res.get("memory", {})
    if res["status"] == "measured":
        size = (f"run={res['seconds']:.4f}s peak="
                f"{(res['peak_bytes'] or 0) / 2**30:.2f}GiB "
                f"bytes={res['counts']['bytes'] / 1e9:.3f}GB")
    else:
        size = (f"trace={res.get('trace_s', 0):.1f}s "
                f"total={mem.get('total_bytes', 0) / 2**30:.1f}GiB "
                f"fits={mem.get('fits', '-')}")
    if r.get("collective_bytes_per_device"):
        size += f" collective={r['collective_bytes_per_device'] / 1e9:.3f}GB"
    print(f"[{res['status']:9s}] {res['arch']} x {res['shape']} x "
          f"{res['mesh']}  {size} bottleneck={r.get('bottleneck', '-')}",
          flush=True)
    if res["status"] == "failed":
        print(res["error"], flush=True)


def _index_cells(shapes, icfg, device, mesh, **kw) -> list:
    """``run_index_cells`` in ``mesh``, or in a one-rank world of this
    process (NCCL on the card, gloo on the CPU)."""
    from ..devices import resolve_device
    from .mesh import single_rank_world

    if mesh is not None:
        return run_index_cells(shapes, mesh, icfg=icfg, device=device, **kw)
    dev = resolve_device(device)
    with single_rank_world(dev.type) as world:
        return run_index_cells(shapes, world, icfg=icfg, device=dev, **kw)


if __name__ == "__main__":
    main()
