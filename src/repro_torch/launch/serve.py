"""Serving launcher: build (or restore) a single-device FM index over a
synthetic corpus and serve batched count queries and a locate batch;
optionally checkpoint the built index so later launches skip the build.

    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna --n 65536
    PYTHONPATH=src python -m repro_torch.launch.serve --n 4096 --device cpu

    # build, checkpoint (step latest+1), serve; then restore and serve
    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna --n 65536 \
        --ckpt-dir idx
    PYTHONPATH=src python -m repro_torch.launch.serve --kind dna \
        --ckpt-dir idx --restore

Segmented catalogs, appends, the async frontend and fault schedules are
not ported yet: argparse rejects their flags.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--locate-k", type=int, default=icfg.locate_k)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--ckpt-dir", default=icfg.ckpt_dir,
                    help="checkpoint the built index here (index_io format)")
    ap.add_argument("--ckpt-keep", type=int, default=icfg.ckpt_keep,
                    help="checkpoint steps to retain under --ckpt-dir")
    ap.add_argument("--restore", action="store_true",
                    help="restore from --ckpt-dir instead of building")
    args = ap.parse_args(argv)
    if args.restore and not args.ckpt_dir:
        ap.error("--restore requires --ckpt-dir")

    from ..core.fm_index import PAD
    from ..core.index_io import (
        describe_index,
        latest_index_step,
        restore_index,
        save_index,
    )
    from ..core.pipeline import build_index
    from ..data.corpus import corpus
    from ..devices import resolve_device

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if args.restore:
        t0 = time.perf_counter()
        info = describe_index(args.ckpt_dir)
        # query patterns must be sampled from the corpus the index was
        # built over: the manifest knows its raw length
        if info.text_length - 1 != args.n:
            print(f"--n {args.n} != checkpointed corpus size "
                  f"{info.text_length - 1}; using the checkpoint's size")
            args.n = info.text_length - 1
        toks = corpus(args.kind, args.n)
        index = restore_index(args.ckpt_dir, device=dev)
        sync()
        print(f"restored {info.kind} index (n={info.length}, "
              f"sigma={info.sigma}, bits={info.bits}) on {dev} in "
              f"{time.perf_counter() - t0:.3f}s")
    else:
        toks = corpus(args.kind, args.n)
        t0 = time.perf_counter()
        index = build_index(toks, sample_rate=icfg.sample_rate,
                            sa_sample_rate=icfg.sa_sample_rate, device=dev)
        sync()
        print(f"index built over {len(toks)} tokens on {dev} in "
              f"{time.perf_counter() - t0:.3f}s")
        if args.ckpt_dir:
            t0 = time.perf_counter()
            latest = latest_index_step(args.ckpt_dir)
            step = save_index(args.ckpt_dir, index,
                              step=0 if latest is None else latest + 1,
                              keep=args.ckpt_keep)
            print(f"checkpointed to {args.ckpt_dir} step {step} in "
                  f"{time.perf_counter() - t0:.3f}s")

    rng = np.random.default_rng(0)

    def sample():
        hi = min(args.pattern_len, len(toks) - 1)
        L = int(rng.integers(3, hi)) if hi > 3 else max(1, hi)
        st = int(rng.integers(0, max(1, len(toks) - L)))
        return toks[st: st + L]

    def batch():
        pats = np.full((args.batch, args.pattern_len), PAD, np.int32)
        for i in range(args.batch):
            p = sample()
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
    print(
        f"{args.batches} batches of {args.batch}: "
        f"p50={lats[len(lats) // 2] * 1e3:.1f}ms "
        f"p99={lats[-1] * 1e3:.1f}ms  total_hits={total}"
    )
    t0 = time.perf_counter()
    pos, counts = index.locate(batch(), args.locate_k)
    found = int(counts.sum())
    print(f"locate batch of {args.batch} (k={args.locate_k}): {found} "
          f"positions in {(time.perf_counter() - t0) * 1e3:.1f}ms")
    return {"total_hits": total, "located": found, "n": args.n}


if __name__ == "__main__":
    main()
