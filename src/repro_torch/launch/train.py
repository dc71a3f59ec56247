"""Training launcher: an LM config trained on the synthetic English corpus
on one card (or the CPU), or in a world of ranks, checkpointed and
resumable.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2p5_3b \\
        --steps 10 --ckpt-dir run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2p5_3b \\
        --steps 10 --ckpt-dir run1 --resume      # continues from the latest
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2p5_3b \\
        --steps 4 --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train -- \\
        --arch qwen2p5_3b --steps 4 --device cpu

The default is the config's reduced form.  One process trains on a
single-device context; under ``torch.distributed.run`` with
``WORLD_SIZE`` over 1 the ranks join the world
(``launch/mesh.py`` ``launched_world``) over the debug mesh of that size
(``make_debug_mesh``: ``(pod, data, model)``) under ``TRAIN_RULES``, each
rank training its blocks of the state (``training/train_loop.py``); ranks
that share a card run gloo.  ``--full`` trains the full config on the
same context: where the reference's ``--full`` builds the production
mesh, a world here is as large as the launcher makes it.

The run uses deterministic algorithms (``train``), so ``--resume``
continues the uninterrupted run's losses bit for bit, on the card too
and in a world (a world's checkpoints are gathered to rank 0 and written
unsharded, so any world size, or one process, resumes them); the cuBLAS
workspace this needs is set before any CUDA work.  Prints ``final loss
<x>``, the last step's loss (in a world rank 0 alone prints).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the full config")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:      # the separator after torch.distributed.run
        argv = argv[1:]
    args = ap.parse_args(argv)

    from ..training.train_loop import CUBLAS_WORKSPACE
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    from ..configs.base import get_config, get_reduced_config
    from ..data.corpus import corpus
    from ..data.loader import LoaderConfig, TokenLoader
    from ..devices import resolve_device
    from ..sharding import TRAIN_RULES, single_device_context, world_context
    from ..training.optimizer import AdamWConfig
    from ..training.train_loop import TrainConfig, train
    from .mesh import launched_world, make_debug_mesh

    device = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    toks = corpus("english", 1 << 17) % (cfg.vocab_size - 1) + 1
    loader = TokenLoader(toks, LoaderConfig(args.batch, args.seq, args.seed))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps),
        compress_grads=args.compress_grads,
        checkpoint_every=max(1, args.steps // 5),
    )
    with launched_world(device, mesh_shape=make_debug_mesh(world)
                        if world > 1 else None) as mesh:
        ctx = (single_device_context() if mesh is None
               else world_context(mesh, TRAIN_RULES))
        first = mesh is None or int(os.environ.get("RANK", "0")) == 0
        res = train(cfg, ctx, tcfg, loader, args.steps,
                    ckpt_dir=args.ckpt_dir, resume=args.resume,
                    seed=args.seed, device=device,
                    log=print if first else (lambda *_: None))
    if not res["losses"]:
        raise SystemExit(f"the run in {args.ckpt_dir} is already at step "
                         f"{args.steps}: no step left to run")
    if first:
        print(f"final loss {res['losses'][-1]:.4f}")
    return res


if __name__ == "__main__":
    main()
