"""End-to-end training on the PyTorch port: BWT-index the corpus,
dedup it, then train a language model on the cleaned stream, as
examples/train_lm.py does; on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_lm.py                # demo
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300

Presets (the same flow scales to a world of ranks via
``repro_torch.launch.train``):
    demo : 1.1M params, seq 64, 60 steps
    100m : 116M params, seq 256, the "~100M for a few hundred steps" run.
"""

import argparse

import numpy as np

from repro_torch.configs.base import get_reduced_config
from repro_torch.data.corpus import corpus
from repro_torch.data.dedup import build_corpus_index, duplicate_window_mask
from repro_torch.data.loader import LoaderConfig, TokenLoader
from repro_torch.devices import resolve_device
from repro_torch.models.transformer import count_params
from repro_torch.sharding import single_device_context
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train

PRESETS = {
    "demo": dict(
        d_model=128, num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, seq=64, batch=8, steps=60,
    ),
    "100m": dict(
        d_model=768, num_layers=12, num_heads=12, num_kv_heads=4, head_dim=64,
        d_ff=3072, vocab_size=8192, seq=256, batch=8, steps=300,
    ),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="demo", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--skip-dedup", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]

    cfg = get_reduced_config("qwen2p5_3b").replace(
        d_model=p["d_model"], num_layers=p["num_layers"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"], vocab_size=p["vocab_size"],
    )
    print(f"model: {count_params(cfg) / 1e6:.1f}M params")

    # 1. corpus + BWT-index dedup (the paper's technique in the pipeline)
    toks = corpus("english", 1 << 17) % (p["vocab_size"] - 1) + 1
    drop_mask = None
    if not args.skip_dedup:
        index = build_corpus_index(toks[: 1 << 16], sample_rate=64,
                                   device=device)
        drop_mask = np.zeros(len(toks), bool)
        dm = duplicate_window_mask(index, toks[: 1 << 16], window=64, stride=256)
        drop_mask[: 1 << 16] = dm
        print(f"dedup: dropping {dm.mean():.2%} of sampled windows")

    loader = TokenLoader(
        toks, LoaderConfig(p["batch"], p["seq"], seed=0), drop_mask=drop_mask
    )

    # 2. train
    ctx = single_device_context()
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps),
        checkpoint_every=max(50, steps // 4),
        log_every=10,
    )
    res = train(cfg, ctx, tcfg, loader, steps, ckpt_dir=args.ckpt_dir,
                resume=args.resume, device=device)
    losses = res["losses"]
    # the first and last 10 steps, or halves of a shorter run; a run of
    # under 4 steps is too short to judge and only prints its losses
    k = min(10, len(losses) // 2) or 1
    print(
        f"loss: {np.mean(losses[:k]):.3f} -> {np.mean(losses[-k:]):.3f} "
        f"over {len(losses)} steps"
    )
    assert k < 2 or np.mean(losses[-k:]) < np.mean(losses[:k]), \
        "did not learn"
    print("train_lm OK")


if __name__ == "__main__":
    main()
