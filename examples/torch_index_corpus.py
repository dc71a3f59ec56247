"""End-to-end corpus indexing on the PyTorch port: build a BWT/FM index over
a synthetic Pizza&Chili-style corpus, then run the two data-hygiene passes
the LM training pipeline uses (dedup + contamination screening), as
examples/index_corpus.py does.

    PYTHONPATH=src python examples/torch_index_corpus.py [--kind dna] \
        [--n 65536] [--device cpu]

Run under ``torch.distributed.run`` to exercise the distributed build
(both sort engines) over a world of ranks (one card each over NCCL where
the host has them, gloo otherwise; rank 0 prints):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        examples/torch_index_corpus.py -- --engine samplesort --device cpu
"""

import argparse
import sys
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core.dist_suffix_array import BITONIC, SAMPLESORT, DistSAConfig
from repro_torch.core.pipeline import build_index
from repro_torch.data.corpus import corpus
from repro_torch.data.dedup import contamination_report, duplicate_window_mask
from repro_torch.devices import resolve_device
from repro_torch.launch.mesh import launched_world


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="dna",
                    choices=["dna", "proteins", "english"])
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--engine", default=BITONIC, choices=[BITONIC, SAMPLESORT])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:      # the separator after torch.distributed.run
        argv = argv[1:]
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    toks = corpus(args.kind, args.n)
    # plant a duplicate: repeat a 512-token slice
    toks = np.concatenate([toks, toks[1000:1512]])

    with launched_world(device) as mesh:
        ndev = 1 if mesh is None else dist.get_world_size()
        say = print if mesh is None or dist.get_rank() == 0 else (
            lambda *a, **k: None)
        t0 = time.time()
        index = build_index(
            toks, mesh, sample_rate=64, device=device,
            sa_config=DistSAConfig(engine=args.engine, capacity_factor=3.0),
        )
        say(
            f"built {args.kind} index over {len(toks)} tokens in "
            f"{time.time() - t0:.1f}s on {ndev} device(s) ({args.engine})"
        )

        t0 = time.time()
        mask = duplicate_window_mask(index, toks, window=64, stride=64)
        dup_frac = mask.mean()
        say(f"dedup: {dup_frac:.2%} of positions in duplicate windows "
            f"({time.time() - t0:.1f}s)")
        assert mask[1024:1400].any(), "planted duplicate not found"

        eval_seqs = [
            toks[5000:5200].copy(),                      # leaked from corpus
            np.full(128, 2, np.int32),                   # generic
            (corpus(args.kind, 256, seed=999) % 4) + 1,  # fresh
        ]
        rep = contamination_report(index, eval_seqs, probe_len=32)
        say(f"contamination: sequences {rep['contaminated']} leak into "
            f"corpus")
        assert 0 in rep["contaminated"]
        say("index_corpus OK")


if __name__ == "__main__":
    main()
