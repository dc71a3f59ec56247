#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py            # every phase, at full size

A run with any option changed (fewer phases, smaller n) is for development:
it ends with ``{"ok": false, "reduced": ...}`` and exit code 1.

Phases, each printing one JSON line; any failed check raises, so the
script exits nonzero and prints no final result:

  0  build the CUDA kernels (one nvcc per source, in parallel), print the
     card's name and power limit and the build seconds
  1  every kernel against its plain PyTorch version on the card (exact
     equality: all outputs are integers), timed beside its bound and,
     where one exists, a single PyTorch library call; torch.profiler gives
     each kernel's device time alone
  2  the main path, DNA at n = 2^28: build_index -> linear SA check on the
     card -> 1024 count + 1024 locate (k=16) requests through FMQueryServer,
     counts checked by brute-force substring match, every located position
     by direct compare; then a second build timed stage by stage, and
     build, count and locate traced with torch.profiler (device time by
     kernel, device-busy share)
  3  the same for proteins at n = 2^24 (sigma 23: the unpacked rank kernel)
  4  cross-device parity at n = 2^16 for dna, proteins and english: the CPU
     build (plain versions) and the CUDA build (kernels) must agree bit for
     bit (SA, BWT, every FMIndex field, counts, locates)

Then a ``kernels`` line (launches on the main paths of phases 2-3, parity
error, times and bounds) and, last, the ``{"ok": true, ...}`` device line.
Exits nonzero without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
LOCATE_K = 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls after one
    warm-up call (CUDA events around the whole run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sector_bytes(word_idx) -> int:
    """Bytes of the distinct 32-byte sectors holding the int32 words at
    flat indices ``word_idx``: what a gather of them must read from HBM."""
    import torch

    return int(torch.unique(word_idx // 8).numel()) * 32


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same(a, b, what: str) -> int:
    """Exact equality of two integer tensors; returns max |a - b| (0)."""
    require(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} != "
                                f"{tuple(b.shape)}")
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    require(err == 0, f"{what}: kernel differs from plain (max err {err})")
    return err


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of one launch of CUDA kernel ``kernel`` (its
    ``__global__`` name) over ``reps`` calls, from torch.profiler: the
    kernel alone, without host gaps between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    require(len(hits) == 1, f"profiler rows for {kernel}: {len(hits)}")
    return hits[0].self_device_time_total / hits[0].count / 1e3


def phase_kernels(log2n_dna: int):
    import torch

    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels import rank_select as rk
    from repro_torch.kernels import ops
    from repro_torch.kernels.radix_hist import radix_hist, radix_hist_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def rint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    # -- rank_packed: main-path layout of DNA (sigma 7, r 64, 4-bit) -------
    n_main = (1 << log2n_dna) + 64          # tokens + sentinel + pad
    errs = []
    for sigma, bits, r in ((7, 4, 64), (4, 2, 64)):
        nb = n_main // r
        W = r * bits // 32
        fused = torch.cat([rint(0, 1 << 30, nb * sigma).view(nb, sigma),
                           rint(-(1 << 31), (1 << 31) - 1, nb * W).view(nb, W)],
                          dim=1).contiguous()
        B = 1024
        blk, c, cut = rint(0, nb, B), rint(0, sigma, B), rint(0, r + 1, B)
        cut[:8], cut[8:16] = 0, r               # the cutoff edges
        got = rk.rank_packed(fused, blk, c, cut, bits=bits, sigma=sigma)
        want = rk.rank_packed_plain(fused, blk, c, cut, bits=bits,
                                    sigma=sigma)
        errs.append(same(got, want, f"rank_packed bits={bits}"))
        if bits == 4:
            main = (fused, blk, c, cut, sigma, bits, nb, W)
    fused, blk, c, cut, sigma, bits, nb, W = main
    # words read: the checkpoint of c, and packed words up to the cutoff word
    row0 = blk.long() * (sigma + W)
    w = torch.arange(W, device=dev)
    upto = torch.clamp(cut.long() // (32 // bits), max=W - 1)
    packed = (row0[:, None] + sigma + w)[w[None, :] <= upto[:, None]]
    read = torch.cat([row0 + c.long(), packed])
    rows["rank_packed"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: rk.rank_packed(fused, blk, c, cut, bits=bits,
                                          sigma=sigma), 200),
        plain_ms=time_ms(lambda: rk.rank_packed_plain(
            fused, blk, c, cut, bits=bits, sigma=sigma), 50),
        bound_ms=bound_ms(sector_bytes(read) + blk.numel() * 16),
        library_ms=None, shape=f"fused[{nb},{sigma + W}], B={blk.numel()}")
    fused_p, blk_p, c_p, cut_p = fused, blk, c, cut
    del main

    # -- rank_select: unpacked blocks at sigma 258 (bytes) ------------------
    r, sig = 64, 258
    nb = (1 << 24) // r
    blocks = rint(0, sig, nb * r).view(nb, r)
    B = 1024
    blk, c, cut = rint(0, nb, B), rint(0, sig, B), rint(0, r + 1, B)
    cut[:8], cut[8:16] = 0, r
    blocks[blk[16:64].long()] = c[16:64, None]   # dense hits for some queries
    got = rk.rank_select(blocks, blk, c, cut)
    want = rk.rank_select_plain(blocks, blk, c, cut)
    # words read: the symbols below each query's cut
    j = torch.arange(r, device=dev)
    read = (blk.long()[:, None] * r + j)[j[None, :] < cut.long()[:, None]]
    rows["rank_select"] = dict(
        max_abs_err=same(got, want, "rank_select"),
        ms=time_ms(lambda: rk.rank_select(blocks, blk, c, cut), 200),
        plain_ms=time_ms(lambda: rk.rank_select_plain(blocks, blk, c, cut),
                         50),
        bound_ms=bound_ms(sector_bytes(read) + B * 16), library_ms=None,
        shape=f"blocks[{nb},{r}], sigma={sig}, B={B}")
    blk_s, c_s, cut_s = blk, c, cut

    # -- radix hist / pos: parity sweeps at n = 2^22 ------------------------
    n = 1 << 22
    keys = rint(-(1 << 31), (1 << 31) - 1, n)
    herr = perr = 0
    for shift in (0, 8, 16, 24):
        h = radix_hist(keys, shift)
        herr = max(herr, same(h, radix_hist_plain(keys, shift),
                              f"radix_hist shift={shift}"))
        base = rs.digit_major_bases(h)
        perr = max(perr, same(rs.radix_pos(keys, base, shift),
                              rs.radix_pos_plain(keys, base, shift),
                              f"radix_pos shift={shift}"))
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    cases = []
    for bits_ in (29, 17, 32):                       # single word
        k = rint(-(1 << 31), (1 << 31) - 1, n)
        if bits_ < 32:
            k = k & ((1 << bits_) - 1)
        cases.append(((k, pay), 1, (bits_,)))
    cases.append(((rint(0, 7, n), rint(0, 11, n), pay), 2, (3, 4)))  # ties
    m = n - 500                                       # forces block padding
    sat = torch.full((m,), (1 << 12) - 1, dtype=torch.int32, device=dev)
    cases.append(((sat, pay[:m]), 1, (12,)))          # saturated + pads
    for operands, nk, kb in cases:
        got = ops.radix_sort(operands, num_keys=nk, key_bits=kb)
        want = ops.local_sort(operands, nk, engine=ops.COMPARE)
        for x, y in zip(got, want):
            perr = max(perr, same(x, y, f"radix_sort key_bits={kb}"))
    require(bool((got[1] == pay[:m]).all()), "saturated keys moved")
    del keys, cases, got, want

    # -- radix parity and timing at the main path's q-gram init shape -------
    nr = n_main + (-n_main) % 1024
    keys = rint(-(1 << 31), (1 << 31) - 1, nr)
    ops3 = (keys, rint(0, 1 << 30, nr), torch.arange(nr, dtype=torch.int32,
                                                     device=dev))
    outs = tuple(torch.empty_like(a) for a in ops3)
    nblk = nr // 1024
    h = radix_hist(keys, 0)
    herr = max(herr, same(h, radix_hist_plain(keys, 0),
                          f"radix_hist n={nr}"))
    base = rs.digit_major_bases(h)
    rs.radix_scatter(keys, base, 0, ops3, outs)
    want = tuple(torch.empty_like(a) for a in ops3)
    rs.radix_scatter_plain(keys, base, 0, ops3, want)
    for k, (x, y) in enumerate(zip(outs, want)):
        perr = max(perr, same(x, y, f"radix_scatter n={nr} operand {k}"))
    del want
    digits = keys & 0xFF
    cell = (torch.arange(nr, device=dev) // 1024) * 256 + digits
    rows["radix_hist"] = dict(
        max_abs_err=herr,
        ms=time_ms(lambda: radix_hist(keys, 0), 10),
        plain_ms=time_ms(lambda: radix_hist_plain(keys, 0), 3),
        bound_ms=bound_ms(4 * nr + nblk * 256 * 4),
        library_ms=time_ms(lambda: torch.bincount(cell,
                                                  minlength=nblk * 256), 3),
        shape=f"keys[{nr}], block=1024")
    del cell
    rows["radix_pos"] = dict(
        max_abs_err=perr,
        ms=time_ms(lambda: rs.radix_scatter(keys, base, 0, ops3, outs), 10),
        plain_ms=time_ms(lambda: rs.radix_scatter_plain(keys, base, 0, ops3,
                                                        outs), 3),
        # the key word is operand 0: read once, then each operand written
        bound_ms=bound_ms(nblk * 256 * 4 + 4 * nr * len(ops3)
                          + 4 * nr * len(outs)),
        library_ms=time_ms(lambda: torch.sort(digits, stable=True), 3),
        shape=f"keys[{nr}], 3 operands scattered")
    calls = {
        "rank_packed": lambda: rk.rank_packed(
            fused_p, blk_p, c_p, cut_p, bits=4, sigma=7),
        "rank_select": lambda: rk.rank_select(blocks, blk_s, c_s, cut_s),
        "radix_hist": lambda: radix_hist(keys, 0),
        "radix_pos": lambda: rs.radix_scatter(keys, base, 0, ops3, outs),
    }
    for name, fn in calls.items():
        rows[name]["device_ms"] = kernel_device_ms(fn, f"{name}_kernel")
    del keys, ops3, outs, digits, base, h
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phases 2-3: the main path at full size
# --------------------------------------------------------------------------

def sample_patterns(toks, count: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5E7]))
    out = []
    for _ in range(count):
        L = int(rng.integers(3, 33))
        st = int(rng.integers(0, len(toks) - L))
        out.append(toks[st: st + L].copy())
    return out


def check_sa(s, sa) -> None:
    """Linear SA check on the card: SA is a permutation, and each adjacent
    pair (a, b) has (s[a], isa[a+1]) < (s[b], isa[b+1]) with the empty
    suffix ranked -1."""
    import torch

    n = s.shape[0]
    dev = s.device
    require(sa.shape[0] == n, "SA length")
    require(int(sa.min()) >= 0 and int(sa.max()) < n, "SA values in range")
    sal = sa.long()
    isa = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    isa[sal] = torch.arange(n, dtype=torch.int32, device=dev)
    require(bool((isa[:n] >= 0).all()), "SA is a permutation")
    a, b = sal[:-1], sal[1:]
    sa_, sb = s[a], s[b]
    ok = (sa_ < sb) | ((sa_ == sb) & (isa[a + 1] < isa[b + 1]))
    require(bool(ok.all()), "SA order (adjacent suffix pairs)")


def check_answers(toks_dev, pats, counts, located, n_brute: int) -> None:
    import torch

    dev = toks_dev.device
    n = toks_dev.shape[0]
    for i in range(n_brute):
        p = torch.as_tensor(pats[i], device=dev)
        L = p.shape[0]
        hit = torch.ones(n - L + 1, dtype=torch.bool, device=dev)
        for j in range(L):
            hit &= toks_dev[j: j + n - L + 1] == p[j]
        require(int(hit.sum()) == counts[i],
                f"count of pattern {i}: {counts[i]} != brute force "
                f"{int(hit.sum())}")
    Lmax = max(len(p) for p in pats)
    starts, plen, pad = [], [], []
    for i, pos in enumerate(located):
        require(len(pos) == min(counts[i], LOCATE_K),
                f"locate {i}: {len(pos)} positions for count {counts[i]}")
        require(all(pos[1:] > pos[:-1]), f"locate {i}: not ascending")
        for q in pos:
            starts.append(int(q))
            plen.append(len(pats[i]))
            row = list(pats[i]) + [0] * (Lmax - len(pats[i]))
            pad.append(row)
    st = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    ln = torch.as_tensor(plen, dtype=torch.int64, device=dev)
    want = torch.as_tensor(pad, dtype=torch.int32, device=dev)
    j = torch.arange(Lmax, device=dev)[None, :]
    require(bool((st >= 0).all() and (st + ln <= n).all()),
            "located positions in range")
    got = toks_dev[torch.clamp(st[:, None] + j, max=n - 1)]
    live = j < ln[:, None]
    require(bool(((got == want) | ~live).all()),
            "a located position does not hold its pattern")


def profiled(fn) -> dict:
    """Run ``fn`` once under torch.profiler (CPU + CUDA activities): wall
    seconds, device-busy share (summed self device time over wall; the
    profiler's own host overhead inflates the wall) and the top device
    time by kernel/op name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    dev_us = sum(r[0] for r in rows)
    return {"wall_s": wall, "device_s": dev_us / 1e6,
            "device_busy_share": dev_us / (wall * 1e6),
            "top": [{"name": k[:48], "device_ms": d / 1e3, "calls": c}
                    for d, k, c in rows[:12]]}


def stage_times(toks, sample_rate: int, sa_sample_rate: int) -> dict:
    """A second build, stage by stage, each ended by a synchronize."""
    import torch

    from repro_torch.core.bwt import bwt_from_sa
    from repro_torch.core.fm_index import build_fm_index
    from repro_torch.core.pipeline import prepare_tokens
    from repro_torch.core.suffix_array import suffix_array_fast

    out = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[name] = t - t0
        t0 = t

    s, sigma = prepare_tokens(toks, sample_rate)
    lap("prepare_tokens_host")
    s_dev = torch.as_tensor(s, device="cuda")
    lap("host_to_device")
    sa, _ = suffix_array_fast(s_dev, sigma, local_sort="auto")
    lap("suffix_array_fast")
    bwt, row = bwt_from_sa(s_dev, sa)
    lap("bwt_from_sa")
    build_fm_index(bwt, row, sigma, sample_rate, sa=sa,
                   sa_sample_rate=sa_sample_rate)
    lap("build_fm_index")
    return out


def phase_main(kind: str, log2n: int, phase: int):
    import torch

    from repro_torch.configs.bwt_index import CONFIG as icfg
    from repro_torch.core.pipeline import SAConfig, build_index, prepare_tokens
    from repro_torch.data.corpus import corpus
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import FMQueryServer

    n = 1 << log2n
    t0 = time.perf_counter()
    toks = corpus(kind, n)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    t0 = time.perf_counter()
    index = build_index(toks, sample_rate=64, sa_sample_rate=32,
                        sa_config=SAConfig(local_sort="auto"), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(_build.LAUNCHES)

    server = FMQueryServer.from_config(index, icfg.replace(locate_k=LOCATE_K),
                                       device="cuda")
    pats = sample_patterns(toks, 1024, seed=phase)
    server.count(pats[:8])                       # warm-up: first launches
    server.locate(pats[:8])
    qps = {}
    for kind_ in ("count", "locate"):
        q0, s0 = server.stats.queries, server.stats.seconds
        if kind_ == "count":
            counts = [int(x) for x in server.count(pats)]
        else:
            located = server.locate(pats)
        qps[kind_] = (server.stats.queries - q0) / (server.stats.seconds - s0)
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # after the counted run, so these launches are not counted
    extra = {
        "stages_s": stage_times(toks, 64, 32),
        "profile_build": profiled(lambda: build_index(
            toks, sample_rate=64, sa_sample_rate=32, device="cuda")),
        "profile_count": profiled(lambda: server.count(pats)),
        "profile_locate": profiled(lambda: server.locate(pats)),
    }

    s, _ = prepare_tokens(toks, 64)
    s_dev = torch.as_tensor(s, device="cuda")
    check_sa(s_dev, index.sa)
    del s_dev
    toks_dev = torch.as_tensor(toks, device="cuda")
    check_answers(toks_dev, pats, counts, located, n_brute=64)
    st = index.build_stats.as_dict()
    emit({"phase": phase, "kind": kind, "n": n, "sigma": index.sigma,
          "packed_bits": index.fm.bits, "corpus_gen_s": gen_s,
          "build_s": build_s, "build_stats": st,
          "count_qps": qps["count"], "locate_qps": qps["locate"],
          "locate_k": LOCATE_K, "requests": {"count": 1024, "locate": 1024},
          "peak_mem_gib": peak_gib, "launches_build": build_launches,
          "launches": launches, "sa_check": "pass",
          "count_check": "64 brute force + 1024 locate-consistent",
          "locate_check": f"{sum(len(p) for p in located)} positions",
          **extra})
    del index, server, toks_dev
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 4: CPU (plain) vs CUDA (kernels) parity
# --------------------------------------------------------------------------

def phase_parity(log2n: int):
    import numpy as np
    import torch

    from repro_torch.core.fm_index import PAD, fm_mismatch
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus

    out = {}
    for kind in ("dna", "proteins", "english"):
        toks = corpus(kind, 1 << log2n)
        cpu = build_index(toks, device="cpu")
        gpu = build_index(toks, device="cuda")
        require(torch.equal(cpu.sa, gpu.sa.cpu()), f"{kind}: SA differs")
        require(torch.equal(cpu.bwt, gpu.bwt.cpu()), f"{kind}: BWT differs")
        mm = fm_mismatch(cpu.fm, gpu.fm)
        require(mm == [], f"{kind}: FMIndex fields differ: {mm}")
        sc, sg = cpu.build_stats.as_dict(), gpu.build_stats.as_dict()
        engines = (sc.pop("local_sort"), sg.pop("local_sort"))
        require(sc == sg, f"{kind}: BuildStats differ {sc} {sg}")
        pats = np.full((256, 24), PAD, np.int32)
        for i, p in enumerate(sample_patterns(toks, 256, seed=40)):
            p = p[:24]
            pats[i, : len(p)] = p
        pats[::7, 1] = 999                      # out-of-alphabet symbols
        require(torch.equal(cpu.count(pats), gpu.count(pats).cpu()),
                f"{kind}: counts differ")
        pc, kc = cpu.locate(pats, LOCATE_K)
        pg, kg = gpu.locate(pats, LOCATE_K)
        require(torch.equal(pc, pg.cpu()) and torch.equal(kc, kg.cpu()),
                f"{kind}: locates differ")
        out[kind] = {"sigma": cpu.sigma, "bits": cpu.fm.bits,
                     "engines": engines, "identical": True}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--dna-log2n", type=int, default=28)
    ap.add_argument("--proteins-log2n", type=int, default=24)
    ap.add_argument("--parity-log2n", type=int, default=16)
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.BUILD_LOG.items()}
    emit({"phase": 0, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "ptxas": ptxas})

    rows = phase_kernels(args.dna_log2n) if 1 in phases else {}
    if rows:
        emit({"phase": 1, "kernels": rows})

    main_launches = {name: 0 for name in _build.KERNELS}
    paths = {2: ("dna", args.dna_log2n, ("rank_packed", "radix_hist",
                                         "radix_pos")),
             3: ("proteins", args.proteins_log2n, ("rank_select",
                                                   "radix_hist",
                                                   "radix_pos"))}
    for phase, (kind, log2n, needed) in paths.items():
        if phase not in phases:
            continue
        launches = phase_main(kind, log2n, phase)
        for name in needed:
            require(launches[name] > 0,
                    f"phase {phase}: kernel {name} never launched")
        for name, v in launches.items():
            main_launches[name] += v

    if 4 in phases:
        emit({"phase": 4, "parity": phase_parity(args.parity_log2n)})

    if rows and {2, 3} <= phases:
        src = "src/repro_torch/kernels/csrc/{}.cu"
        replaces = {
            "rank_packed": "src/repro/kernels/rank_select.py:133",
            "rank_select": "src/repro/kernels/rank_select.py:179",
            "radix_hist": "src/repro/kernels/radix_hist.py:25",
            "radix_pos": "src/repro/kernels/radix_sort.py:54",
        }
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": src.format(name),
             "replaces": replaces[name], "launches": main_launches[name],
             "max_abs_err": rows[name]["max_abs_err"],
             "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
             "bound_ms": rows[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": rows[name]["library_ms"],
             "device_ms": rows[name]["device_ms"],
             "shape": rows[name]["shape"]}
            for name in _build.KERNELS]})
    print(card, flush=True)
    reduced = {k: v for k, v in vars(args).items()
               if v != ap.get_default(k)}
    if reduced:
        # a development run: never ends with the full run's result
        emit({"ok": False, "reduced": reduced})
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
