"""Serving example on the PyTorch port: batched FM-index pattern counting
(the index side) and batched LM token decoding (the model side) from one
process, as examples/serve_queries.py does; on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_queries.py [--device cpu]

Querying
--------
``FMQueryServer`` (serving/engine.py) is the production front door: it
micro-batches mixed count/locate requests into length buckets over an
index built with SA sampling enabled::

    from repro_torch.core.pipeline import build_index
    from repro_torch.serving.engine import FMQueryServer

    index = build_index(tokens, sample_rate=64, sa_sample_rate=32)
    server = FMQueryServer(index, length_buckets=(8, 16, 32), locate_k=16)

    server.count([q1, q2, q3])        # -> np.ndarray of exact-match counts
    server.locate([q1], k=8)          # -> [positions per query]

    t_a = server.submit(q_a, "count")  # or: interleave kinds explicitly,
    t_b = server.submit(q_b, "locate") # flush once, read by ticket
    results = server.flush()
    results[t_b].positions
    print(server.throughput_report())  # queries/s across flushes

On the card each served batch of a bucket is one fused query launch
(backward search, and for locate the LF walk to the SA sample).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_reduced_config
from repro_torch.core import alphabet as al
from repro_torch.core.fm_index import PAD
from repro_torch.core.pipeline import build_index
from repro_torch.data.corpus import corpus
from repro_torch.devices import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.sharding import single_device_context


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def serve_fm(device, n=1 << 15, batch=256, rounds=5):
    from repro_torch.configs.bwt_index import CONFIG as icfg
    from repro_torch.serving.engine import FMQueryServer

    toks = corpus("proteins", n)
    index = build_index(toks, sample_rate=64,
                        sa_sample_rate=icfg.sa_sample_rate, device=device)
    s = al.append_sentinel(toks)
    rng = np.random.default_rng(0)
    server = FMQueryServer.from_config(index, icfg.replace(locate_k=8),
                                       device=device)
    lat = []
    for _ in range(rounds):
        pats = np.full((batch, 12), PAD, np.int32)
        for i in range(batch):
            L = rng.integers(3, 12)
            st = rng.integers(0, n - L - 1)
            pats[i, :L] = s[st : st + L]
        t0 = time.perf_counter()
        counts = index.count(pats).cpu().numpy()
        lat.append(time.perf_counter() - t0)
        assert (counts >= 1).all()  # all sampled from the corpus
    lat_ms = sorted(x * 1e3 for x in lat)
    print(
        f"FM serving: batch={batch} p50={lat_ms[len(lat_ms) // 2]:.1f}ms "
        f"-> {batch / min(lat):.0f} queries/s"
    )

    # mixed micro-batched traffic through the server front door
    queries = [s[st : st + 8] for st in rng.integers(0, n - 9, 32)]
    tickets = [server.submit(q, kind) for q, kind in
               zip(queries, ["count", "locate"] * 16)]
    results = server.flush()
    hits = results[tickets[1]].positions
    assert len(hits) >= 1 and np.array_equal(s[hits[0]:hits[0] + 8], queries[1])
    print(server.throughput_report())


def serve_lm(device, batch=4, prompt_len=8, gen=16):
    ctx = single_device_context()
    cfg = get_reduced_config("qwen2p5_3b")
    params = tf.init_model(cfg, torch.Generator(device).manual_seed(0),
                           torch.float32, device)
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)

    cache = tf.init_cache(cfg, batch, prompt_len + gen, torch.float32, device)
    out = []
    tok = torch.as_tensor(prompts[:, :1], device=device)
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for pos in range(prompt_len + gen):
            logits, cache = tf.decode_step(params, cache, tok, pos, cfg, ctx)
            if pos + 1 < prompt_len:
                tok = torch.as_tensor(prompts[:, pos + 1 : pos + 2],
                                      device=device)
            else:
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
                out.append(tok[:, 0].cpu().numpy())
    _sync(device)
    dt = time.perf_counter() - t0
    toks_s = batch * (prompt_len + gen) / dt
    print(f"LM decode: {batch}x{prompt_len + gen} tokens, {toks_s:.0f} tok/s")
    assert len(out) == gen + 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    serve_fm(device)
    serve_lm(device)
    print("serve_queries OK")


if __name__ == "__main__":
    main()
