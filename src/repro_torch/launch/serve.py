"""Serving launcher: build (or restore) an FM index, on one device or
distributed over the ranks of a world, or a segmented catalog, over a
synthetic corpus and serve batched count queries and a locate batch, or
mixed requests through the async frontend; optionally checkpoint it so
later launches skip the build.

    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna --n 65536
    PYTHONPATH=src python -m repro_torch.launch.serve --n 4096 --device cpu

    # build, checkpoint (step latest+1), serve; then restore and serve
    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna --n 65536 \
        --ckpt-dir idx
    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna \
        --ckpt-dir idx --restore

    # async frontend: admission-controlled queue, per-bucket p50/p99 SLOs
    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna --n 65536 \
        --serve-async --queue-depth 4096 --max-wait-ms 2 --slo-p99-ms 50

    # segmented catalog: build + save, then restore and append new text
    # (each append followed by the background compaction policy; with
    # --serve-async the appends go through the live frontend)
    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna \
        --n 65536 --segments 4 --ckpt-dir cat
    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir cat \
        --restore --append new_tokens.npy --serve-async

    # a distributed index over a world of 2 ranks (--engine picks the mesh
    # build's sort); every rank builds, saves and serves its shard, rank 0
    # prints and writes; --restore puts the checkpoint back on the mesh.
    # The "--" keeps torch.distributed.run's parser off the launcher's
    # arguments (some Python releases read --n as one of its options)
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve -- --n 65536 --engine samplesort \
        --ckpt-dir idx
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve -- --ckpt-dir idx --restore

When the environment of ``torch.distributed.run`` names a world of more
than one rank (``WORLD_SIZE > 1``), the launcher joins it
(``launch/mesh.py`` ``launched_world``: NCCL with a card per rank, gloo
for ranks that share a card or run on the CPU) and builds, saves,
restores and serves on that mesh; segmented catalogs and the async
frontend are single-process paths.

``--fault-schedule`` arms deterministic fault injection
(``testing/faultinject.py``) for the run and prints a fault report at its
end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def main(argv=None):
    from ..configs.bwt_index import CONFIG as icfg

    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="dna")
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--pattern-len", type=int, default=16)
    ap.add_argument("--engine", default="bitonic",
                    choices=("bitonic", "samplesort"),
                    help="the mesh build's distributed sort (DistSAConfig)")
    ap.add_argument("--locate-k", type=int, default=icfg.locate_k)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--ckpt-dir", default=icfg.ckpt_dir,
                    help="checkpoint the built index here (index_io format)")
    ap.add_argument("--ckpt-keep", type=int, default=icfg.ckpt_keep,
                    help="checkpoint steps to retain under --ckpt-dir")
    ap.add_argument("--restore", action="store_true",
                    help="restore from --ckpt-dir instead of building")
    ap.add_argument("--segments", type=int, default=0,
                    help="build a segmented catalog of this many segments "
                         "(0 = monolithic index); saved under --ckpt-dir "
                         "as a SegmentedIndex catalog")
    ap.add_argument("--append", action="append", default=[],
                    metavar="TOKENS_FILE",
                    help="append tokens (.npy, or .npz with a 'tokens' "
                         "array) to the built or restored segmented "
                         "catalog; repeatable.  Each append runs the "
                         "background compaction policy; the catalog is "
                         "re-saved to --ckpt-dir")
    ap.add_argument("--serve-async", action="store_true",
                    help="serve through the admission-controlled async "
                         "frontend (per-request submits, SLO metrics)")
    ap.add_argument("--queue-depth", type=int, default=icfg.serve_queue_depth,
                    help="admission bound: submits beyond this shed")
    ap.add_argument("--max-wait-ms", type=float,
                    default=icfg.serve_max_wait_ms,
                    help="flush coalescing window for the async frontend")
    ap.add_argument("--slo-p99-ms", type=float, default=icfg.serve_slo_p99_ms,
                    help="per-bucket p99 latency target for count queries")
    ap.add_argument("--slo-p99-ms-locate", type=float,
                    default=icfg.serve_slo_p99_ms_locate,
                    help="per-bucket p99 latency target for locate queries")
    ap.add_argument("--locate-frac", type=float, default=0.2,
                    help="fraction of async requests issued as locate")
    ap.add_argument("--fault-schedule", default=None, metavar="SPEC",
                    help="arm deterministic fault injection for this run: "
                         "comma-separated failpoint triggers like "
                         "'io.write:0,merge.mid:1' (repro_torch.testing."
                         "faultinject); a fault report prints on exit")
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:
        # the separator after ``torch.distributed.run -m ...``: some
        # Python 3.12 releases hand it on to the script
        argv = argv[1:]
    args = ap.parse_args(argv)
    if args.restore and not args.ckpt_dir:
        ap.error("--restore requires --ckpt-dir")
    if args.segments > args.n:
        ap.error(f"--segments {args.segments} exceeds --n {args.n} "
                 "(every segment needs at least one token)")

    from ..devices import resolve_device
    from .mesh import launched_world

    dev = resolve_device(args.device)
    with launched_world(dev) as mesh:
        if mesh is not None and (args.segments or args.append
                                 or args.serve_async):
            ap.error("--segments, --append and --serve-async run in one "
                     "process, not in a world of ranks")
        return _serve(ap, args, icfg, dev, mesh)


def _quiet(*args, **kwargs) -> None:
    """``print`` of the ranks other than 0."""


def _serve(ap, args, icfg, dev, mesh):
    """The launcher's work once its arguments are parsed and its world (if
    any) joined: every rank of a world runs it, making the same calls."""
    import torch.distributed as dist

    from ..testing import faultinject

    say = print if mesh is None or dist.get_rank() == 0 else _quiet
    where = str(dev) if mesh is None else (
        f"{dev}, {dist.get_world_size()} ranks "
        f"({dist.get_backend()})")
    if args.fault_schedule:
        faultinject.arm(faultinject.FaultSchedule.parse(args.fault_schedule))
        say(f"fault schedule armed: {args.fault_schedule}")

    from ..core.fm_index import PAD
    from ..core.index_io import (
        describe_index,
        latest_index_step,
        restore_index,
        save_index,
    )
    from ..core.pipeline import build_index, mesh_sa_config
    from ..core.segments import SegmentedIndex, unstored_knobs
    from ..data.corpus import corpus

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def load_tokens(path):
        if path.endswith(".npz"):
            with np.load(path) as z:
                return np.asarray(z["tokens"], np.int32)
        return np.asarray(np.load(path), np.int32)

    appended = [load_tokens(p) for p in args.append]
    catalog_json = (os.path.join(args.ckpt_dir, "catalog.json")
                    if args.ckpt_dir else None)

    if args.restore and catalog_json and os.path.exists(catalog_json):
        if mesh is not None:
            ap.error(f"{args.ckpt_dir} holds a segmented catalog, which "
                     "restores in one process, not in a world of ranks")
        t0 = time.perf_counter()
        # the catalog stores no cost model or fan-out: take the config's
        index = SegmentedIndex.load(args.ckpt_dir, device=dev,
                                    **unstored_knobs(icfg))
        for q in index.quarantined:
            say(f"WARNING: segment {q['seg_id']} quarantined "
                f"({q['reason']}); serving degraded")
        if not index.segments:
            ap.error(f"catalog under {args.ckpt_dir} has no healthy "
                     "segments left to serve")
        toks = np.concatenate([s.tokens for s in index.segments])
        args.n = len(toks)
        sync()
        say(f"restored segmented catalog ({len(index.segments)} segments, "
            f"{index.total_tokens} tokens, sigma={index.sigma}) on {dev} "
            f"in {time.perf_counter() - t0:.3f}s")
    elif args.restore:
        t0 = time.perf_counter()
        info = describe_index(args.ckpt_dir)
        # query patterns must be sampled from the corpus the index was
        # built over: the manifest knows its raw length
        if info.text_length - 1 != args.n:
            say(f"--n {args.n} != checkpointed corpus size "
                f"{info.text_length - 1}; using the checkpoint's size")
            args.n = info.text_length - 1
        toks = corpus(args.kind, args.n)
        index = restore_index(args.ckpt_dir, mesh, device=dev)
        sync()
        say(f"restored {info.kind} index (n={info.length}, "
            f"sigma={info.sigma}, bits={info.bits}) on {where} in "
            f"{time.perf_counter() - t0:.3f}s")
    elif args.segments > 0:
        toks = corpus(args.kind, args.n)
        t0 = time.perf_counter()
        index = SegmentedIndex.from_config(int(toks.max()) + 1, icfg,
                                           device=dev)
        for chunk in np.array_split(toks, args.segments):
            index.append(chunk)
        sync()
        say(f"segmented catalog built over {len(toks)} tokens "
            f"({args.segments} segments) on {dev} in "
            f"{time.perf_counter() - t0:.3f}s")
    else:
        toks = corpus(args.kind, args.n)
        t0 = time.perf_counter()
        index = build_index(toks, mesh, sample_rate=icfg.sample_rate,
                            sa_sample_rate=icfg.sa_sample_rate,
                            sa_config=mesh_sa_config(
                                icfg.replace(engine=args.engine)),
                            device=dev)
        sync()
        say(f"index built over {len(toks)} tokens on {where} in "
            f"{time.perf_counter() - t0:.3f}s")
        if args.ckpt_dir:
            t0 = time.perf_counter()
            latest = latest_index_step(args.ckpt_dir)
            step = save_index(args.ckpt_dir, index,
                              step=0 if latest is None else latest + 1,
                              keep=args.ckpt_keep)
            say(f"checkpointed to {args.ckpt_dir} step {step} in "
                f"{time.perf_counter() - t0:.3f}s")

    segmented = isinstance(index, SegmentedIndex)
    if appended and not segmented:
        ap.error("--append requires a segmented catalog "
                 "(--segments N, or --restore of one)")
    if not args.serve_async:
        # the async path routes appends through the frontend's control
        # queue instead (compaction between flushes)
        for extra in appended:
            t0 = time.perf_counter()
            index.append(extra)
            merges = index.maybe_compact()
            sync()
            say(f"appended {len(extra)} tokens ({merges} compactions, "
                f"{len(index.segments)} segments) in "
                f"{time.perf_counter() - t0:.3f}s")

    def save_catalog():
        t0 = time.perf_counter()
        index.save(args.ckpt_dir)
        say(f"segmented catalog saved to {args.ckpt_dir} in "
            f"{time.perf_counter() - t0:.3f}s")

    if segmented and args.ckpt_dir and not args.serve_async:
        save_catalog()

    # query patterns come from every text source, so appended segments
    # are exercised beside the old ones
    sources = [toks] + appended
    rng = np.random.default_rng(0)

    def sample(active_sources):
        src = active_sources[int(rng.integers(len(active_sources)))]
        hi = min(args.pattern_len, len(src) - 1)
        L = int(rng.integers(3, hi)) if hi > 3 else max(1, hi)
        st = int(rng.integers(0, max(1, len(src) - L)))
        return src[st: st + L]

    def fault_report():
        if faultinject.active() is not None:
            say(f"fault report: {faultinject.active().report()}")

    n_total = args.n + sum(len(a) for a in appended)
    if args.serve_async:
        from ..serving.engine import FMQueryServer
        from ..serving.frontend import AsyncQueryFrontend, Rejected

        server = FMQueryServer.from_config(index, icfg, device=dev)
        can_locate = (getattr(index, "sa_sample_rate", 0)
                      or getattr(getattr(index, "fm", None),
                                 "sa_sample_rate", 0)) != 0

        def submit(fe, active_sources):
            # each request's kind is drawn before its pattern, as in the
            # reference, so one argv serves the same requests in both
            kind = ("locate" if can_locate
                    and rng.random() < args.locate_frac else "count")
            return fe.submit(sample(active_sources), kind,
                             k=args.locate_k if kind == "locate" else None)

        with AsyncQueryFrontend.from_config(
            server, icfg, max_queue=args.queue_depth,
            max_wait_ms=args.max_wait_ms,
            slo_p99_ms={"count": args.slo_p99_ms,
                        "locate": args.slo_p99_ms_locate},
        ) as fe:
            total = args.batches * args.batch
            futs = [submit(fe, [toks])
                    for _ in range(total // 2 if appended else total)]
            for extra in appended:
                # live growth between flushes: append + compaction on the
                # worker thread while queries keep flowing
                info = fe.append(extra).result()
                say(f"async-appended {info['appended']} tokens "
                    f"({info['merges']} compactions, {info['segments']} "
                    f"segments)")
            futs += [submit(fe, sources) for _ in range(total - len(futs))]
            hits = shed = 0
            for f in futs:
                r = f.result()
                if isinstance(r, Rejected):
                    shed += 1
                else:
                    hits += r.count
            m = fe.metrics()
        if segmented and args.ckpt_dir:
            save_catalog()
        say(json.dumps(m, indent=2))
        say(f"async-serve: {m['completed']} answered ({shed} shed) "
            f"at {m['qps']:.0f} qps, total_hits={hits}")
        fault_report()
        return {"total_hits": hits, "n": n_total,
                "segments": len(index.segments) if segmented else 0,
                "metrics": m}

    def batch():
        pats = np.full((args.batch, args.pattern_len), PAD, np.int32)
        for i in range(args.batch):
            p = sample(sources)
            pats[i, : len(p)] = p
        return pats

    lats = []
    total = 0
    for _ in range(args.batches):
        pats = batch()
        t0 = time.perf_counter()
        counts = index.count(pats).cpu().numpy()
        lats.append(time.perf_counter() - t0)
        total += int(counts.sum())
    lats.sort()
    say(
        f"{args.batches} batches of {args.batch}: "
        f"p50={lats[len(lats) // 2] * 1e3:.1f}ms "
        f"p99={lats[-1] * 1e3:.1f}ms  total_hits={total}"
    )
    t0 = time.perf_counter()
    pos, counts = index.locate(batch(), args.locate_k)
    found = int(counts.sum())
    say(f"locate batch of {args.batch} (k={args.locate_k}): {found} "
        f"positions in {(time.perf_counter() - t0) * 1e3:.1f}ms")
    fault_report()
    return {"total_hits": total, "located": found, "n": n_total,
            "segments": len(index.segments) if segmented else 0}


if __name__ == "__main__":
    main()
