"""Variants of three cells, each estimated on ``meta`` and, where the
estimate fits the card, measured on it (the reference's hypothesis ->
change -> measure loop, with measured times in place of re-lowered
rooflines).

    PYTHONPATH=src python -m repro_torch.launch.perf qwen_train
    PYTHONPATH=src python -m repro_torch.launch.perf musicgen_decode
    PYTHONPATH=src python -m repro_torch.launch.perf bwt_build [variant ...]
    ... perf qwen_train fsdp_v3 --device cpu    # a per-rank estimate only

A variant runs on the card only when its ``dryrun.trace_cell`` estimate
(argument bytes plus the step's peak) fits the card's free memory
(``roofline.HBM_BYTES`` less what the process already holds); otherwise
it records the estimate and the reason.  Each variant's JSON lands in
``<out>/<name>__<variant>.json`` (default ``build/perf/``, gitignored).

* ``qwen_train`` (qwen2p5_3b, train_4k): ``baseline`` and ``dots_remat``
  run the cell's step with its accumulation cut to 2 micro-batches of
  2 x 4096 (the cut is in ``reduced``): seconds a micro-batch, the AdamW
  seconds, the peak, and the full step extrapolated as n_micro x micro +
  AdamW.  ``micro1`` (the 256 x 4096 batch at once) is estimated only.
  The ``fsdp_*`` variants change only the sharding rules, which one card
  does not have: each is a step of the reference's 256-rank 16x16 mesh,
  read per rank on ``meta`` (``dryrun.trace_mesh_cell``), status
  ``estimated``.  The three one-card variants carry the same per-rank
  16x16 estimate under their own levers (``mesh_estimate``), so the rule
  sets compare with their baseline on one mesh, as the reference compares
  them.
* ``musicgen_decode`` (musicgen_medium, decode_32k): ``baseline`` (bf16
  cache) and ``fp8_cache``, both at the largest power-of-two batch whose
  bf16 cache cell fits: ms a step against its bytes bound; each also
  with its per-rank 16x16 estimate at the shape's batch
  (``mesh_estimate``).
* ``bwt_build``: ``baseline``, ``rounds10``, ``rounds10_cap125`` and
  ``bitonic``, each a one-rank build at the config's n: seconds, peak, the
  capacity factor after any overflow retry, and whether its suffix array
  equals the baseline's (a capped round budget can leave long repeats
  unsorted: that is reported).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import gc
import json
import multiprocessing
import time
from pathlib import Path

import torch

from ..configs.base import get_config
from ..sharding import TRAIN_RULES
from . import dryrun
from . import roofline as rf

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "perf"
QWEN_RUN = dict(n_micro=2, micro_batch=2)   # the measured step's cut
DECODE_STEPS = 4
# the mesh of the per-rank estimates: the reference's one-pod mesh
PERF_MESH = "16x16"
MESH_REASON = "a step of the 256-rank mesh, read per rank on meta"

QWEN_VARIANTS = {
    "baseline": {},
    "dots_remat": {"remat": "dots"},
    "micro1": {"n_micro": 1},
}
# the reference's rule sets.  v2: the batch over every axis (pure data
# parallelism with ZeRO-3, no tensor parallelism), the vocab unsharded.
# v3: as v2, the embedding and lm_head vocab-sharded over model again
# (v2 keeps their 6.2 GB of optimizer state whole on every rank); the
# logits keep the batch on (pod, data, model), ``spec_for`` dropping the
# conflicting vocab split.
FSDP_V2 = dict(TRAIN_RULES, heads=(), kv_heads=(), mlp=(), inner=(),
               act_model=(), vocab=(), batch=("pod", "data", "model"),
               fsdp=("data",))
FSDP_V3 = dict(FSDP_V2, vocab=("model",))
# the variants that change only the rules: one card has no such layout,
# so each is estimated per rank on the 16x16 mesh
QWEN_MESH_VARIANTS = {
    "fsdp_v2": {"rules": FSDP_V2},
    "fsdp_v2_dots": {"rules": FSDP_V2, "remat": "dots"},
    "fsdp_v3": {"rules": FSDP_V3},
    "fsdp_v3_dots": {"rules": FSDP_V3, "remat": "dots"},
}
MUSICGEN_VARIANTS = {
    "baseline": {},
    "fp8_cache": {"cache_dtype": torch.float8_e4m3fn},
}
BWT_VARIANTS = {
    "baseline": {},                       # ceil(log2 n) rounds, cap 2.0
    "rounds10": {"rounds": 10},           # a capped round budget
    "rounds10_cap125": {"rounds": 10, "capacity_factor": 1.25},
    "bitonic": {"engine": "bitonic", "rounds": 10},
}
# the targets with per-rank mesh estimates: (config, shape, variants)
MESH_ESTIMATED = {
    "qwen_train": ("qwen2p5_3b", "train_4k",
                   {**QWEN_VARIANTS, **QWEN_MESH_VARIANTS}),
    "musicgen_decode": ("musicgen_medium", "decode_32k", MUSICGEN_VARIANTS),
}


def _report(name, variant, res, out_dir) -> dict:
    res = dict(res, target=name, variant=variant)
    est = res.get("estimate", {}).get("memory", {})
    mesh = res.get("mesh_estimate") or (res["estimate"] if "mesh" in res
                                        else None)
    per_rank = "" if mesh is None else (
        f" {PERF_MESH} rank={mesh['memory']['total_bytes'] / 2**30:.2f}GiB "
        f"collective={mesh['roofline']['collective_s']:.4f}s")
    print(f"[{name}/{variant}] {res['status']} "
          f"estimate={est.get('total_bytes', 0) / 2**30:.2f}GiB "
          f"fits={est.get('fits', '-')} "
          f"measured_s={res.get('measured_s')} "
          f"peak={res.get('peak_bytes')}{per_rank}", flush=True)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{name}__{variant}.json", "w") as f:
        json.dump(res, f, indent=2, default=str)
    return res


def _estimate(cfg, shape, **kw) -> dict:
    rec = dryrun.trace_cell(cfg, shape, **kw)
    return {k: rec[k] for k in ("memory", "counts", "roofline", "trace_s",
                                "n_micro", "micro_batch", "update")
            if k in rec}


def _mesh_estimate(cfg, shape, kw: dict) -> dict:
    """The per-rank estimate of the cell on ``PERF_MESH``
    (``dryrun.trace_mesh_cell`` under the variant's levers ``kw``), with
    its model FLOPs and their share of the mesh's counted FLOPs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dryrun.with_model_flops(
            dryrun.trace_mesh_cell(cfg, shape, PERF_MESH, **kw), cfg)
    finally:
        torch.set_num_threads(threads)


def mesh_estimates(target: str, variants=None, *, config_of=get_config,
                   pool=None) -> dict:
    """{variant: a call that gives its per-rank ``PERF_MESH`` estimate}
    for ``target``'s variants (those named in ``variants``, or all):
    submitted to ``pool`` (an executor of spawned processes, each trace in
    a meta world of its own) at once, so they trace while other work
    runs; traced in this process when first called, without one."""
    arch, shape, table = MESH_ESTIMATED[target]
    cfg = config_of(arch)
    chosen = _chosen(table, variants)
    if pool is None:
        return {v: functools.cache(functools.partial(_mesh_estimate, cfg,
                                                     shape, kw))
                for v, kw in chosen.items()}
    futures = {v: pool.submit(_mesh_estimate, cfg, shape, kw)
               for v, kw in chosen.items()}
    return {v: f.result for v, f in futures.items()}


def estimate_pool(jobs: int):
    """An executor of ``jobs`` spawned processes for the mesh estimates
    (None for one: they trace in this process)."""
    if jobs <= 1:
        return None
    return concurrent.futures.ProcessPoolExecutor(
        jobs, mp_context=multiprocessing.get_context("spawn"))


def _free_bytes(device) -> int:
    """What the card has left for this process: its free memory once the
    allocator's cached blocks and unreachable tensors are released
    (``HBM_BYTES`` for the CPU rehearsal)."""
    if torch.device(device).type != "cuda":
        return rf.HBM_BYTES
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def _fits(est: dict, device) -> bool:
    return est["memory"]["total_bytes"] <= _free_bytes(device)


def _random_params(cfg, device, seed: int = 0):
    from ..models import transformer as tf

    gen = torch.Generator(device).manual_seed(seed)
    return tf.init_model(cfg, gen, torch.bfloat16, device)


def _run_train(cfg, remat: str, n_micro: int, micro_batch: int, device):
    """Two steps of ``n_micro`` micro-batches of ``micro_batch`` x 4096
    tokens (random weights and tokens from a seed): the second step's
    seconds per micro-batch and AdamW seconds, and the peak of both."""
    from ..models.common import tree_leaves
    from ..sharding import TRAIN_RULES, single_device_context
    from ..training.optimizer import init_opt_state

    ctx = single_device_context(TRAIN_RULES)
    S = dryrun.SHAPES["train_4k"]["seq_len"]
    base = dryrun._reset_peak(device)
    params = _random_params(cfg, device)
    opt = init_opt_state(params)
    gen = torch.Generator(device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (n_micro * micro_batch, S),
                           generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    micro = dryrun._accumulate_fn(cfg, ctx, remat)
    update = dryrun._update_fn(n_micro)
    steps = []
    for _ in range(2):
        acc = dryrun._zeros32(params)
        times, losses = [], []
        for mb in dryrun._micro_slices(batch, n_micro):
            t0 = time.perf_counter()
            losses.append(micro(params, acc, mb))
            dryrun._sync(device)
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        update(params, opt, acc)
        dryrun._sync(device)
        steps.append({"micro_s": times, "adamw_s": time.perf_counter() - t0,
                      "loss": float(sum(losses) / n_micro)})
        del acc
    finite = all(bool(torch.isfinite(p.float()).all())
                 for p in tree_leaves(params))
    peak = dryrun._peak(device, base)
    del params, opt
    return steps, peak, finite


def _chosen(table: dict, variants) -> dict:
    return {v: kw for v, kw in table.items() if not variants or v in variants}


def qwen_train(variants=None, *, out_dir=OUT_DIR, device=None,
               config_of=get_config, estimates=None) -> list:
    """Target: the train cell that fits one card nearest its full step
    (the per-rank mesh estimates from ``estimates``, ``mesh_estimates``,
    or traced here)."""
    from ..devices import resolve_device

    name = "qwen_train"
    device = resolve_device(device)
    cfg = config_of("qwen2p5_3b")
    full_n = min(dryrun._micro_batches(cfg, "train_4k", dryrun.CHIPS),
                 dryrun.SHAPES["train_4k"]["global_batch"])
    mesh = estimates or mesh_estimates(name, variants, config_of=config_of)
    out = []
    for v, kw in _chosen(QWEN_VARIANTS, variants).items():
        remat = kw.get("remat", "full")
        if v == "micro1":
            est = _estimate(cfg, "train_4k", remat=remat, n_micro=1)
            res = {"status": "estimated", "estimate": est,
                   "mesh_estimate": mesh[v](),
                   "reason": "the 256 x 4096 batch in one micro-batch: "
                             "estimated only"}
            out.append(_report(name, v, res, out_dir))
            continue
        n, mbs = QWEN_RUN["n_micro"], QWEN_RUN["micro_batch"]
        est = _estimate(cfg, "train_4k", remat=remat, n_micro=n,
                        global_batch=n * mbs)
        res = {"estimate": est, "remat": remat, "n_micro_full": full_n,
               "reduced": {"n_micro": [full_n, n],
                           "global_batch": [
                               dryrun.SHAPES["train_4k"]["global_batch"],
                               n * mbs]}}
        if not _fits(est, device):
            res.update(status="estimated", mesh_estimate=mesh[v](),
                       reason="the estimate does not fit the card's memory")
            out.append(_report(name, v, res, out_dir))
            continue
        steps, peak, finite = _run_train(cfg, remat, n, mbs, device)
        micro_s = sum(steps[1]["micro_s"]) / n
        micro_flops = est["micro_batch"]["flops"]
        res.update(status="measured", steps=steps, micro_s=micro_s,
                   adamw_s=steps[1]["adamw_s"], measured_s=micro_s,
                   peak_bytes=peak, finite=finite,
                   bound_s=micro_flops / rf.PEAK_FLOPS["bf16"],
                   bound_by="operations",
                   extrapolated_step_s=full_n * micro_s + steps[1]["adamw_s"],
                   extrapolated="n_micro_full x micro_s + adamw_s",
                   mesh_estimate=mesh[v]())
        out.append(_report(name, v, res, out_dir))
    for v, kw in _chosen(QWEN_MESH_VARIANTS, variants).items():
        est = mesh[v]()
        res = {"status": "estimated", "mesh": PERF_MESH,
               "chips": est["chips"], "estimate": est,
               "remat": kw.get("remat", "full"), "reason": MESH_REASON}
        out.append(_report(name, v, res, out_dir))
    return out


def _decode_batch(cfg, shape: str, max_batch: int, device) -> int:
    """The largest power-of-two batch (up to ``max_batch``) whose bf16
    cache cell fits the card."""
    B = max_batch
    while B > 1 and not _fits(dryrun.trace_cell(cfg, shape, global_batch=B),
                              device):
        B //= 2
    return B


def musicgen_decode(variants=None, *, out_dir=OUT_DIR, device=None,
                    config_of=get_config, max_batch=None,
                    estimates=None) -> list:
    """Target: the worst roofline fraction (memory-bound MHA decode; the
    per-rank mesh estimates from ``estimates`` or traced here)."""
    from ..devices import resolve_device
    from ..models import transformer as tf
    from ..sharding import DECODE_RULES, single_device_context

    name = "musicgen_decode"
    shape = "decode_32k"
    device = resolve_device(device)
    cfg = config_of("musicgen_medium")
    S = dryrun.SHAPES[shape]["seq_len"]
    B = _decode_batch(cfg, shape,
                      max_batch or dryrun.SHAPES[shape]["global_batch"],
                      device)
    ctx = single_device_context(DECODE_RULES)
    decode = dryrun._decode_fn(cfg, ctx)
    mesh = estimates or mesh_estimates(name, variants, config_of=config_of)
    out = []
    for v, kw in _chosen(MUSICGEN_VARIANTS, variants).items():
        est = _estimate(cfg, shape, global_batch=B, **kw)
        res = {"estimate": est, "batch": B, "cache_len": S,
               "cache_dtype": str(kw.get("cache_dtype", torch.bfloat16)),
               "reduced": {"global_batch": [
                   dryrun.SHAPES[shape]["global_batch"], B]}}
        if not _fits(est, device):
            res.update(status="estimated", mesh_estimate=mesh[v](),
                       reason="the estimate does not fit the card's memory")
            out.append(_report(name, v, res, out_dir))
            continue
        base = dryrun._reset_peak(device)
        params = _random_params(cfg, device)
        # the cache the estimate holds as an argument, zeroed at its
        # shapes (``init_cache`` would add one layer's cache while it
        # stacks the groups)
        cache = tf.tree_map(
            lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
            dryrun.cell_inputs(cfg, shape, global_batch=B,
                               cache_dtype=kw.get("cache_dtype"))[2][
                "cache"].tree)
        gen = torch.Generator(device).manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                               device=device, dtype=torch.int32)
        # decode_step returns the cache it wrote in place: keep no
        # second reference to it, so ``del cache`` frees it
        logits = decode(params, cache, tokens, S - 1)[0]    # warm-up
        dryrun._sync(device)
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            logits = decode(params, cache, tokens, S - 1)[0]
        dryrun._sync(device)
        step_s = (time.perf_counter() - t0) / DECODE_STEPS
        finite = bool(torch.isfinite(logits.float()).all())
        peak = dryrun._peak(device, base)
        del params, cache, logits
        res.update(status="measured", measured_s=step_s, ms_per_step=step_s
                   * 1e3, steps=DECODE_STEPS, peak_bytes=peak, finite=finite,
                   bound_s=est["counts"]["bytes"] / rf.HBM_BW,
                   bound_by="bytes", mesh_estimate=mesh[v]())
        out.append(_report(name, v, res, out_dir))
    return out


def bwt_build(variants=None, *, out_dir=OUT_DIR, device=None, icfg=None,
              mesh=None) -> list:
    """Target: the paper's own workload (index construction), one rank
    (in ``mesh``, or a one-rank world of this process: NCCL on the card)."""
    from ..devices import resolve_device
    from .mesh import single_rank_world

    device = resolve_device(device)
    if mesh is None:
        with single_rank_world(device.type) as world:
            return _bwt_build(variants, out_dir, device, icfg, world)
    return _bwt_build(variants, out_dir, device, icfg, mesh)


def _bwt_build(variants, out_dir, device, icfg, mesh) -> list:
    from ..configs.bwt_index import CONFIG
    from ..data.corpus import corpus

    name = "bwt_build"
    icfg = icfg or CONFIG
    tokens = corpus("english", icfg.n)
    base_sa, out = None, []
    for v, kw in BWT_VARIANTS.items():
        if variants and v not in variants and not (v == "baseline"
                                                    and base_sa is None):
            continue
        vcfg = icfg.replace(**kw)
        base = dryrun._reset_peak(device)
        t0 = time.perf_counter()
        index = dryrun.index_build(tokens, mesh, vcfg, device)
        dryrun._sync(device)
        seconds = time.perf_counter() - t0
        peak = dryrun._peak(device, base)
        if v == "baseline":
            base_sa = index.sa
        same = bool(torch.equal(index.sa, base_sa))
        res = {"status": "measured", "measured_s": seconds,
               "peak_bytes": peak, "n": vcfg.n, "engine": vcfg.engine,
               "rounds": vcfg.rounds,
               "capacity_factor": vcfg.capacity_factor,
               "capacity_factor_used": index.mesh_config.capacity_factor,
               "overflow_retried": (index.mesh_config.capacity_factor
                                    != vcfg.capacity_factor),
               "sa_equals_baseline": same,
               "sa_positions_differing": (
                   0 if same else int((index.sa != base_sa).sum()))}
        del index
        if not variants or v in variants:
            out.append(_report(name, v, res, out_dir))
    return out


TARGETS = {
    "qwen_train": qwen_train,
    "musicgen_decode": musicgen_decode,
    "bwt_build": bwt_build,
}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", nargs="?", default="all",
                    choices=["all", *TARGETS])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain path (the "
                         "fsdp variants are per-rank estimates anywhere)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="per-rank mesh estimates traced in parallel "
                         "processes")
    args = ap.parse_args(argv)
    out = []
    pool = estimate_pool(args.jobs)
    try:
        for name, fn in TARGETS.items():
            if args.target in ("all", name):
                kw = ({"estimates": mesh_estimates(
                    name, args.variants or None, pool=pool)}
                      if name in MESH_ESTIMATED else {})
                out += fn(args.variants or None, out_dir=args.out,
                          device=args.device, **kw)
    finally:
        if pool is not None:
            pool.shutdown()
    return out


if __name__ == "__main__":
    main()
