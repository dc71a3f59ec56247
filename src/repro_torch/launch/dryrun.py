"""Dry run of every (architecture x input shape) cell on one H100: each LM
cell's step traced on ``meta`` at full width and depth for its memory and
roofline, and the bwt_index cells built and served for real.

The JAX package lowers and compiles each cell on 512 forced host devices
and reads XLA's memory and cost analyses; on one card the same proof is a
full-size step run on ``meta`` tensors under ``roofline.count``: it
allocates nothing and fails on any shape mismatch, and it counts the
step's matmul FLOPs, bytes and the high-water mark of the storage it
creates.  A cell's memory is its argument bytes (params, optimizer state,
batch, cache) plus that peak, against the card's ``HBM_BYTES``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all
    ... dryrun --arch qwen2p5_3b --shape train_4k
    ... dryrun --arch bwt_index            # build + serve on the card
    ... dryrun --list
    ... dryrun --no-compile                # specs only, no trace

Results land in ``<out>/<arch>__<shape>__h100x1.json`` (default
``build/dryrun/``, gitignored) and feed ``launch/report.py``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config
from ..models import transformer as tf
from ..models.common import tree_leaves, tree_map
from ..sharding import DECODE_RULES, TRAIN_RULES, single_device_context
from ..training.optimizer import AdamWConfig, adamw_update
from . import roofline as rf
from .specs import (
    SHAPES,
    batch_specs,
    cache_specs,
    opt_state_abstract,
    param_specs_abstract,
    shape_skip_reason,
    tree_nbytes,
)

MESH = "h100x1"
CHIPS = 1
OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
INDEX_SHAPES = ("build", "serve")


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------

def _grad_fn(cfg, ctx, remat="full"):
    """(params, batch) -> (loss, grads): the loss gradient of one
    micro-batch by autograd, each stacked group rematerialised by
    ``remat``; grads in the params' dtype."""
    def grad(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss = tf.loss_fn(live, batch, cfg, ctx, remat_policy=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        return loss.detach(), tree_map(lambda t: by_leaf[id(t)], live)

    return grad


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


def _update_fn(n_micro: int, opt_cfg=AdamWConfig()):
    """(params, opt, grads) -> None: the accumulated gradient's mean, then
    AdamW in place."""
    def update(params, opt, grads):
        with torch.no_grad():
            if n_micro > 1:
                for g in tree_leaves(grads):
                    g.div_(n_micro)
            adamw_update(grads, opt, params, opt_cfg)

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


def _decode_fn(cfg, ctx):
    def decode(params, cache, tokens, pos):
        with torch.no_grad():
            return tf.decode_step(params, cache, tokens, pos, cfg, ctx)

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

def cell_inputs(cfg, shape: str, *, rules=None, cache_dtype=None,
                global_batch: int | None = None):
    """(ctx, kind, {name: Abstract}) of one cell on this card's mesh;
    ``global_batch`` overrides the shape's batch."""
    kind = SHAPES[shape]["kind"]
    if rules is None:
        rules = TRAIN_RULES if kind == "train" else DECODE_RULES
    ctx = single_device_context(rules)
    params = param_specs_abstract(cfg, ctx, torch.bfloat16)
    args = {"params": params,
            "batch": batch_specs(cfg, shape, ctx, global_batch=global_batch)}
    if kind == "train":
        args["opt_state"] = opt_state_abstract(params, ctx)
    if kind == "decode":
        args["cache"] = cache_specs(cfg, shape, ctx, dtype=cache_dtype,
                                    global_batch=global_batch)
    return ctx, kind, args


def trace_cell(cfg, shape: str, *, rules=None, remat: str = "full",
               n_micro: int | None = None, cache_dtype=None,
               global_batch: int | None = None) -> dict:
    """One LM cell's step on ``meta`` under ``roofline.count``: its memory
    (argument bytes by kind, the step's peak temp bytes, their total and
    whether it fits ``HBM_BYTES``) and its counts.  The keyword overrides
    (rules / remat / n_micro / cache_dtype / global_batch) are perf's
    variant levers.

    A train step traces one micro-batch and scales its counts by
    ``n_micro`` (every micro-batch runs the same ops), then traces AdamW
    once; its temp peak is the float32 accumulator plus the larger of the
    two traces' peaks (one micro-batch's, the update's)."""
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
        mb = _micro_slices(args["batch"].tree, n_micro)[0]
        if n_micro == 1:
            (_, grads), micro = rf.count(_grad_fn(cfg, ctx, remat), params,
                                         mb)
            _, update = rf.count(_update_fn(1), params,
                                 args["opt_state"].tree, grads)
            # the grads are the update's argument, alive through it
            update.peak_bytes += tree_nbytes(grads)
            counts = micro + update
        else:
            acc, init = rf.count(_zeros32, params)
            _, micro = rf.count(_accumulate_fn(cfg, ctx, remat), params, acc,
                                mb)
            _, update = rf.count(_update_fn(n_micro), params,
                                 args["opt_state"].tree, acc)
            counts = init + micro.scaled(n_micro) + update
            counts.peak_bytes = tree_nbytes(acc) + max(micro.peak_bytes,
                                                       update.peak_bytes)
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
    rec["memory"] = {"argument_size_in_bytes": arg,
                     "temp_size_in_bytes": counts.peak_bytes,
                     "total_bytes": arg + counts.peak_bytes,
                     "hbm_bytes": rf.HBM_BYTES,
                     "fits": arg + counts.peak_bytes <= rf.HBM_BYTES}
    rec["counts"] = counts.to_dict()
    roof = rf.Roofline(counts.flops, counts.bytes, 0.0, {}, CHIPS,
                       counts.dtype)
    rec["roofline"] = roof.to_dict()
    rec["tokens"] = tokens
    return rec


def run_cell(arch: str, shape: str, *, compile_: bool = True,
             config_of=get_config) -> dict:
    """One LM cell: skipped for the reference's reason, its specs only
    (``compile_=False``), or traced (``trace_cell``)."""
    cfg = config_of(arch)
    base = {"arch": arch, "shape": shape, "mesh": MESH, "chips": CHIPS,
            "kind": SHAPES[shape]["kind"]}
    reason = shape_skip_reason(cfg, shape)
    if reason:
        return dict(base, status="skipped", reason=reason)
    if not compile_:
        _, _, args = cell_inputs(cfg, shape)
        return dict(base, status="specs", argument_bytes={
            k: tree_nbytes(v.tree) for k, v in args.items()})
    rec = dict(base, status="traced", **trace_cell(cfg, shape))
    mf = rf.model_flops(cfg, rec["tokens"])
    rec["model_flops"] = mf
    rec["roofline"]["model_flops"] = mf
    hw = rec["roofline"]["flops_per_device"] * CHIPS
    rec["roofline"]["useful_flops_ratio"] = mf / hw if hw else None
    return rec


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


def run_index_cells(shapes, mesh, *, icfg=None, device=None) -> list:
    """The bwt_index cells on a one-part ``mesh``: ``build`` runs
    ``build_index(tokens, mesh)`` over the english corpus at the config's
    n once under ``roofline.count`` (launch counts reset just before it,
    read just after), then once more timed alone; ``serve`` counts one
    ``dist_count`` batch of ``query_batch`` x ``query_len`` substrings
    of the text, then times a second.  Each records seconds, peak memory,
    the counts (the kernels' reported bytes in them), collective bytes by
    kind and the roofline."""
    from ..configs.bwt_index import CONFIG
    from ..data.corpus import corpus
    from ..devices import resolve_device

    icfg = icfg or CONFIG
    device = resolve_device(device)
    t0 = time.perf_counter()
    tokens = corpus("english", icfg.n)
    gen_s = time.perf_counter() - t0
    out, index = [], None
    if "build" in shapes or "serve" in shapes:
        index, counts, peak, launches, records = _counted(
            index_build, tokens, mesh, icfg, device, device=device)
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


def _one(cell, compile_, config_of):
    """One LM cell in a pool worker: the record, or the failure's."""
    arch, shape = cell
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        return run_cell(arch, shape, compile_=compile_, config_of=config_of)
    except Exception:
        return {"arch": arch, "shape": shape, "mesh": MESH,
                "status": "failed", "error": traceback.format_exc(),
                "trace_s": time.perf_counter() - t0}


def cells_of(arch: str = "all", shape: str = "all") -> list:
    lm_archs = [a for a in ARCH_IDS if a != "bwt_index"]
    archs = lm_archs + ["bwt_index"] if arch == "all" else [arch]
    cells = []
    for a in archs:
        shapes = (list(INDEX_SHAPES) if a == "bwt_index"
                  else (list(SHAPES) if shape == "all" else [shape]))
        cells += [(a, s) for s in shapes]
    return cells


def main(argv=None, *, config_of=get_config, index_cfg=None,
         index_device=None, index_mesh=None) -> list:
    """Run the cells the arguments name and write one JSON each; returns
    the records.  Raises ``SystemExit(1)`` after the last cell when any
    cell failed.  The keyword arguments are for rehearsals: other LM
    configs (``get_reduced_config``), another index config and device,
    and an index mesh to run in (default: a one-rank world of its own,
    NCCL on the card)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--no-compile", action="store_true",
                    help="specs only, no trace (and no index cell)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="LM cells traced in parallel processes")
    args = ap.parse_args(argv)

    cells = cells_of(args.arch, args.shape)
    if args.list:
        for arch, shape in cells:
            print((arch, shape, MESH))
        return []

    lm = [c for c in cells if c[0] != "bwt_index"]
    index = [s for a, s in cells if a == "bwt_index"]
    if args.jobs > 1 and len(lm) > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as pool:
            results = list(pool.map(_one, lm, [not args.no_compile] * len(lm),
                                    [config_of] * len(lm)))
    else:
        threads = torch.get_num_threads()
        try:
            results = [_one(c, not args.no_compile, config_of) for c in lm]
        finally:
            torch.set_num_threads(threads)
    for res in results:
        _emit(res, args.out)
    if index and not args.no_compile:
        for res in _index_cells(index, index_cfg, index_device, index_mesh):
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
    print(f"[{res['status']:9s}] {res['arch']} x {res['shape']} x {MESH}  "
          f"{size} bottleneck={r.get('bottleneck', '-')}", flush=True)
    if res["status"] == "failed":
        print(res["error"], flush=True)


def _index_cells(shapes, icfg, device, mesh) -> list:
    """``run_index_cells`` in ``mesh``, or in a one-rank world of this
    process (NCCL on the card, gloo on the CPU)."""
    from ..devices import resolve_device
    from .mesh import single_rank_world

    if mesh is not None:
        return run_index_cells(shapes, mesh, icfg=icfg, device=device)
    dev = resolve_device(device)
    with single_rank_world(dev.type) as world:
        return run_index_cells(shapes, world, icfg=icfg, device=dev)


if __name__ == "__main__":
    main()
