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
     each kernel's device time alone, per launch it recorded; the
     single-batch rank kernels' latency floors (one dependent load over
     their operand, from scripts/pointer_chase.cu, plus an empty
     launch).  rank_select at every group size its plan can return over r
     = 7, 32, 64, 128, 512, sigma 23 and 258, batches of 1, 7, 1024,
     16,384 queries (cut 0 and r among them) and 655,360 consecutive rows,
     on 16-byte aligned blocks and on a view 4 bytes off; at B = 1024,
     16,384 and the consecutive rows its plan, every group size's time and
     the kernel before its redesign (scripts/rank_select_warp.cu) beside
     it, L2-cold in turns and with clock64() stamps of both
     (scripts/rank_select_stamps.cu).  rerank_scan on an edge sweep (tile
     edges, aliased and misaligned operands, runs of whole tiles,
     INT32_MAX tails) and timed on the q-gram words (also
     aliased), the seed builder's first-round pairs, all-equal pairs at
     2^28 and 2^14 pairs, each beside a streaming torch.add of the same
     bytes.  The fused query kernels first on a 2-bit index at n = 2^20
     (raw and bit-packed SA values, 512-symbol blocks, and unpacked at
     r = 64 and 128)
  2  the main path, DNA at n = 2^28: build_index -> linear SA check on the
     card -> 1024 count + 1024 locate (k=16) requests through FMQueryServer,
     counts checked by brute-force substring match, every located position
     by direct compare, one fused query launch per served batch and no
     single-batch rank launch; then a second build timed stage by stage,
     and build, count and locate traced with torch.profiler (device time by
     kernel, device-busy share).  On the built index the fused query kernel
     against its plain version (the requests as served, edge patterns, k =
     0, 1, 16, 64), its time per length bucket beside its bound, dependent
     steps and latency floor (the steps x one load's latency from
     scripts/pointer_chase.cu), and the earlier one-rank-launch-per-step
     design against it in turns
  3  the same for proteins at n = 2^24 (sigma 23: the unpacked layout)
  4  cross-device parity at n = 2^16 for dna, proteins and english: the CPU
     build (plain versions) and the CUDA build (kernels) must agree bit for
     bit (SA, BWT, every FMIndex field, counts, locates), for the fast and
     the seed builder; the single-query functions (occ, backward_search,
     bwt_symbol, locate_naive) on both, the card's through the single-batch
     rank kernels, and the competitor's suffix_array_rpgi / bwt_rpgi of
     4096 tokens on both devices equal to the fast build
  5  the seed builder (Init -> (Pair, Re-rank)*) on DNA n = 2^28: SA, BWT
     and every FMIndex field equal phase 2's fast build
  6  save -> restore of phase 2's index: the stored-layout restore and a
     copy without the layout (the derived-layout branch) must equal the
     built index and answer phase 2's requests identically; then the
     serving launcher with --ckpt-dir and --restore (proteins, n = 2^24)
  7  the rebuild-free BWT merge: the merge_walk kernel against its plain
     walks on small walks (about 2^12 steps; pairwise and k-way, packed and
     unpacked, k = 2, 3, 8, 33; a 1100-segment run against the rebuild),
     each also at the SA rate's seed stride and twice it, and its seeds'
     meeting steps equal to the plain chained model's
     (merge_walk.chained_walk), then three merges of documents prepared as
     segment appends (r = 64, SA stride 32): (a) DNA k-way over eight
     documents of 2^20, 2^19 x 2, 2^18 x 2 and 2^17 x 3 tokens, (b) the
     pairwise fold of the same eight, (c) proteins k-way over 2^19, 2^18 x
     2 and 2^17, each run once through the entry points.  Each walk's ins
     equals the one the suffix arrays of the documents and of the rebuild
     imply, its seeds' meeting steps the model's; each merge equals the
     rebuild of the concatenation in every field and answers 1024 count
     and 1024 locate requests identically; each walk is one merge_walk
     launch and one rank launch (the walked rows' LF map); per walk its
     chains (seed stride, chains, seeds met / tried, median and maximum
     steps to meet, longest chain), its time beside its bytes bound and
     its latency floor (the longest chain's steps, seed included, x one
     load's latency, from scripts/pointer_chase.cu over the left
     operand's size), precompute, splice + build_fm_index, the rebuild,
     and the card's merge cost constants; the LF map of each merge's last
     walk (one rank_packed or rank_select batch over every walked row)
     timed beside its bytes bound and latency floor, rank_select's beside
     the kernel before its redesign
  8  the segmented catalog: (a) the DNA corpus of phase 2 split into 16
     segments as the launcher's --segments does (SegmentedIndex.from_config,
     the card's config), 1024 count + 1024 locate requests through
     FMQueryServer: one fm_query_stacked_packed launch per served batch and
     no other query or rank launch, counts by brute force inside the
     segments, every located position, every batch equal to the sequential
     path (one single-index query per segment) and the stacked kernel equal
     to its plain version (the served buckets; edge patterns at k = 0, 1,
     16, 64; the bucket cut to n_seg = 1, 2, 4, 8, 16, rows [:n_seg]), its
     time beside its bytes bound over n_seg x B lanes, its latency floor
     (dependent loads x one load's latency from scripts/pointer_chase.cu
     over the bucket's words) and its dependent steps; the stacked kernel
     before its redesign (scripts/fm_query_stacked_lanes.cu, built beside
     the kernels) held to the plain version the same way and timed in turns
     with it, L2-cold: at B = 1024 and 64, for count, on short patterns,
     over the n_seg sweep, with both kernels' registers, resident blocks and
     waves, and the packed kernel at each tile size; then phase 7's eight
     documents appended with maybe_compact after each (the bucket
     re-stacks at 32 segments, the eighth compacts through the backstop;
     answers equal across the compaction), forced k-way and rebuild
     compactions of them on two more catalogs (equal to each other and to
     the served catalog's), save ->
     load of the catalog (same catalog, same answers) and a second save
     after one more append (only the new segment's files written); (b)
     proteins at n = 2^24 in 4 segments: fm_query_stacked_unpacked, the
     same serving checks, and the same corpus in 16 segments for the
     unpacked kernel's sweep; (c) a 2-bit catalog of 5 segments (seg_pad
     8), the same kernel checks
  9  the async frontend (serving/frontend.py) on the card: (a) phase 2's
     DNA index (parked on the host through phases 7-8) behind
     FMQueryServer.from_config and AsyncQueryFrontend.from_config, 16,384
     requests per scenario (lengths 3-32 from the text, 20% locate, k =
     16): a closed loop of 64 client threads, an open loop at 70% of its
     qps, an unpaced burst into a 64-deep queue (max_wait_ms 0.5) that
     must shed; a profiled closed-loop window (device-busy share, given
     only when the profiler saw every launch the wrapper counted) and the
     sync flush of the same requests; (c) faults: worker.flush armed at
     its first hit (only that flush's futures fail, one worker restart),
     deadline_ms=0 behind a full batch (DeadlineExceeded), stop() with
     requests pending (every future resolves); (b) the DNA corpus as a
     16-segment catalog: the closed loop, then an open loop while
     fe.append adds phase 7's eight documents one by one (each request
     equal to the direct answer of a catalog state between the appends
     resolved at its submission and those submitted at its answer;
     requests after an append see its text); (d) launch.serve
     --serve-async --segments 4 --append --ckpt-dir at n = 2^24 and the
     saved catalog reloaded; (e) dedup: DNA 2^24 with its first 2^20
     tokens planted again, duplicate_window_mask (window 32, batch 4096)
     flagging both copies, 1024 windows against brute force, and
     contamination_report on 1024 sequences.  Every answer equals the
     direct index call (made before a frontend starts or after it stops);
     each served bucket chunk is one fm_query_packed or
     fm_query_stacked_packed launch and no rank kernel launches; a future
     that raises or a worker restart outside (c) fails the run; per-bucket
     p50/p99 print beside the SLOs (a p99 over its SLO is a finding, not a
     failure)
 10  the distributed build and query (build_index(tokens, mesh),
     SequenceIndex.count / .locate on the mesh index): (a) one NCCL rank
     in this process (the one multi-rank transport that owns the card):
     DNA at n = 2^28 by the bitonic engine and proteins at 2^24 (the
     unpacked rank_select layout), their SA, BWT and row equal phase 2's /
     phase 3's builds and phase 2's / 3's 1024 count and 1024 locate
     requests (one batch each) answered identically; DNA 2^24 by
     samplesort against its single-device build; build time, peak memory,
     launches and collectives per build and per served batch, the stages
     of a second DNA build (prepare, ISA with its rounds, BWT, FM build),
     rank_packed / rank_select on the one-part indexes at the locate
     walk's 16,384 lanes against their plain versions, beside their bytes
     bounds and latency floors (rank_select also beside the kernel before
     its redesign); (b) gloo worlds of 2 and 4 ranks sharing the card (their
     collectives staged through pinned host buffers): DNA 2^24 and
     proteins 2^22 by both engines and DNA by samplesort from a capacity
     factor of 0.5, which overflows (shown by a first ISA build) and
     retries, each equal to the single-device build of the same prepared
     text and its answers on every rank; whether NCCL takes two ranks on
     the one card.  Checkpoints: (a) the DNA 2^28 one-rank mesh index
     saved (save_index gathers to rank 0), restored on one device
     (mesh=None) and onto the one-rank mesh, and phase 6's single-device
     checkpoint of phase 2 restored onto the mesh, each answering phase
     2's 1024 count + 1024 locate requests (one batch each) identically,
     with save s, host npz read s, restore s beside the mesh build, peak
     memory, and char_histogram launches per restore and rank launches
     per batch (a mesh restore that launches no char_histogram fails);
     (b) the world of 4 saves its DNA 2^24 bitonic build, the world of 2
     restores it and so does this process on one device, every answer
     equal to the single-device build's; (c) the serving launcher as a
     world of 2 through python -m torch.distributed.run (gloo: the ranks
     share the card) at n = 2^20 by samplesort with --ckpt-dir, then
     --restore, both runs printing the same total_hits (the two runs
     overlap (b)'s worlds).  A rank that raises or outlives its world's
     timeout fails the run
 11  LM serving (models/*, serving/engine.generate; no index kernel, and
     none may launch): (a) each of the ten reduced configs in float32 on
     the card against the CPU on the same weights (made on the CPU from a
     seeded generator): forward at B = 2, S = 16 (S = 2048 for qwen2p5_3b
     and minicpm3_4b, the chunked attention), 8 decode steps, generate with
     8 new tokens (equal tokens, or a first difference where the CPU's
     top-2 logits tie); (b) minitron_4b at full width and depth and (c)
     mamba2_1p3b at full width and depth, bf16 weights drawn on the card:
     generate at B = 8 with 64 + 64 tokens (tokens/s, ms a step, peak
     memory), forward(last_token_only) at B = 1, S = 2048, and for (b)
     decode against forward on 16 positions; (d) deepseek_v2_236b at full
     width cut to 3 layers (the dense layer and two MLA + MoE layers of 160
     experts): generate at B = 8 with 16 + 16 tokens, forward at B = 4,
     S = 1024 (capacity 192).  Each part frees its weights before the next
 12  LM training (training/*, launch/train.py; float32 matmuls at "highest"
     precision and cuDNN TF32 off, both printed): (a) each of the ten
     reduced configs: one make_train_step on the card against the CPU
     from the same float32 state (made on the CPU from a seeded generator):
     loss, grad_norm, lr and every updated leaf of params / m / v within
     1e-4 of 1 + |x| (MoE 1e-3), and the loss under remat "full", "dots"
     and "none"; (b) test_bitwise_resume's scenario on the card (reduced
     qwen2p5_3b, vocab 128: 12 steps against 6 and a resume to 12), and
     the same for reduced deepseek_v2_236b, through ``train`` (which runs
     with deterministic algorithms; the losses must be equal), and steps
     repeated from one state with deterministic algorithms on (equal) and
     off (reported); (c)
     examples/train_lm.py's pipeline at full width: the english corpus at
     2^22 tokens indexed on the card and screened by
     duplicate_window_mask (window 64, stride 256), then qwen2p5_3b at full
     width and depth (3.40 B params, float32 params, grads and AdamW
     moments) trained on the screened stream through ``train``: B = 2, S =
     1024, remat "full", 4 steps: s a step, tokens/s and peak memory beside
     the float32 bound, a profiled step, deterministic algorithms on
     against off in turns, and one step under remat "dots" with its peak;
     (d) mamba2_1p3b at full width with int8 gradient compression, B = 2,
     S = 2048, 3 steps, the same report; (e) ``python -m
     repro_torch.launch.train --arch qwen2p5_3b --steps 10 --ckpt-dir``,
     then the same with --resume from a copy of its checkpoints cut back
     to step 6: the same final loss and the same step-10 arrays bit for
     bit
 13  the launch tools (launch/{specs,roofline,dryrun,perf,report}.py):
     (a) dryrun.main over every cell: the 40 LM cells (ten configs x
     train_4k / prefill_32k / decode_32k / long_500k) traced on meta at
     full width and depth in parallel processes, or skipped for the
     reference's reason (long_500k of a full-attention config), each
     with its argument bytes, peak temp bytes and fit against the card's
     memory, counted FLOPs and bytes and roofline; the two bwt_index
     cells in a one-rank NCCL world at the config's n = 2^28 on the
     english corpus (sigma 257): build_index(tokens, mesh) with the
     config's engine, capacity factor and rounds, and one dist_count
     batch of 1024 x 32 substrings, each counted (the kernels' reported
     bytes in it) and timed; (b) perf's targets: qwen2p5_3b train_4k
     baseline and dots_remat (2 micro-batches of 2 x 4096, the full step
     extrapolated) where their estimates fit, micro1 estimated;
     musicgen_medium decode_32k bf16 and fp8 caches at the largest
     power-of-two batch whose bf16 cell fits; four bwt_build variants at
     n = 2^28; then report.main's three tables.  A cell that fails to
     trace, a measured time under its bound (a micro-batch under its
     FLOPs over the bf16 peak, a decode step or an index cell under its
     bytes over 3.35 TB/s) or a measured peak more than 10% over its
     meta estimate fails the run
 14  LM serving in worlds of ranks sharing the card (gloo; their CUDA
     tensors staged through pinned host buffers; no index kernel may
     launch in any rank): (a) the ten reduced configs in float32 in a
     world of 4 ranks (pod 1, data 2, model 2), and the two MoE configs
     also in one of 8 (2, 2, 2), each against the same world on the CPU
     (the four worlds side by side): forward at B = 4, S = 16, decode
     logits along 8 tokens, generate 4 + 8 tokens (equal tokens, or a
     first difference at a CPU top-2 tie);
     (b) minitron_4b at full width and depth in float32 and (c)
     deepseek_v2_236b at full width cut to 3 layers in bf16, each run on
     one rank in this process and then in a world of 2 (1, 1, 2) from the
     same seeded weights: forward(last_token_only) (B = 8, S = 256 and B
     = 4, S = 1024) within LM_TOL of 1 + |b|, or for (c) within 5% of the
     max |logit|; (b)'s greedy generate at B = 8 (4 + 8 tokens) equal
     but at a near tie, with s a decode step and the collectives of a
     step by kind; each rank's heads and experts, and its peak memory
 15  LM training in worlds of ranks sharing the card (gloo, host-staged;
     no index kernel may launch in any rank): (a) in phase 14 (a)'s
     worlds, after each config's serving cases, one train step of it
     under TRAIN_RULES (qwen2p5_3b also with int8 compression), each
     rank's loss, grad_norm, gradient blocks and updated param / moment
     blocks against the same world on the CPU (STEP_TOL, gradients
     LM_TOL, MoE LM_MOE_TOL); (b) qwen2p5_3b at full width, depth cut,
     float32, remat "full", in a world of 4 (pod 1, data 2, model 2:
     ZeRO-3 over data, heads / mlp / vocab over model) at B = 4, S =
     1024 for 3 steps, against the same cut trained on one rank in this
     process (losses and grad norms within LM_TOL of 1 + |b|), a world
     checkpoint of step 2 restored and step 3 repeated bit for bit; s a
     step, the collectives of a step by kind, pass and bytes, peak memory
     a rank, the single rank's s a step and peak

Launch counts are set to 0 just before each path (the phase 2 and 3 main
paths, the seed build, each restore, each merge of phase 7, each catalog
of phase 8: its appends and its serving, each frontend scenario of phase
9, its launcher call and its dedup, each distributed build of phase 10
with its two served batches, summed over a world's ranks, and each
restore of phase 10 with its two batches, phase 4's single-query calls
per corpus, phase 11, phase 12's screen, its reduced parts and its
full-width runs, and phase 13's counted index build and served batch and
its perf bwt_build, phase 14 and phase 15, each summed over its ranks)
and read just after it.  Then a ``kernels`` line
(launches on the main paths of phases 2-3, 7-10, phase 12's screen and
phase 13, and on each path, parity error, times and bounds), the card's
name and power limit and, last, the ``{"ok": true, ...}`` device line.  A
kernel time under its bound (bytes over the card's HBM peak), or a merge
walk under its latency floor, fails the run as a broken measurement.
Exits nonzero without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
LOCATE_K = 16
# the build profiles list these rows: the re-rank kernel beside the memsets
# (its scratch's among them)
BUILD_WATCH = ("rerank_kernel", "Memset")
ROOT = Path(__file__).resolve().parent
# the pointer chase that measures one dependent load's latency, the merge
# walks' bound: its source and its C entry's argument types (next, steps,
# out, stream)
CHASE_SRC = ROOT / "scripts" / "pointer_chase.cu"
CHASE_ARGTYPES = ("c_void_p", "c_int", "c_void_p", "c_void_p")
# the unpacked single-batch rank kernel before its redesign (one query a
# warp), timed in turns with the port's: its source and its C entry's
# argument types (blocks, r, blk, sym, cut, out, B, stream)
WARP_SRC = ROOT / "scripts" / "rank_select_warp.cu"
WARP_ARGTYPES = {"rank_select_warp_launch": ("c_void_p", "c_int") +
                 ("c_void_p",) * 4 + ("c_int", "c_void_p")}
# both rank_select kernels with clock64() stamps: its source and its C
# entry's argument types (blocks, r, blk, sym, cut, out, B, group, stamps,
# stream)
STAMPS_SRC = ROOT / "scripts" / "rank_select_stamps.cu"
STAMPS_ARGTYPES = {"rank_select_stamps_launch": ("c_void_p", "c_int") +
                   ("c_void_p",) * 4 + ("c_int", "c_int", "c_void_p",
                                        "c_void_p")}
# the stacked query kernel before its redesign (one thread per segment,
# pattern and slot), timed in turns with the port's: its source and its C
# entries' argument types (the port's stacked wrappers' C arguments up to
# k, then sp, ep, positions, stream; the occupancy query: unpacked, bits,
# sigma, out)
LANES_SRC = ROOT / "scripts" / "fm_query_stacked_lanes.cu"
_LANES_TAIL = ("c_void_p",) * 4 + ("c_longlong", "c_longlong", "c_int",
                                   "c_void_p", "c_int", "c_int", "c_int") \
    + ("c_void_p",) * 4
LANES_ARGTYPES = {
    "stacked_lanes_packed_launch": ("c_void_p", "c_int", "c_int", "c_int",
                                    "c_int", "c_int", "c_int", "c_int",
                                    "c_void_p", "c_void_p") + _LANES_TAIL,
    "stacked_lanes_unpacked_launch": ("c_void_p", "c_void_p", "c_int",
                                      "c_int", "c_int", "c_int", "c_int",
                                      "c_void_p", "c_void_p") + _LANES_TAIL,
    "stacked_lanes_occupancy": ("c_int", "c_int", "c_int", "c_void_p"),
}


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


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same(a, b, what: str, ref: str = "plain") -> int:
    """Exact equality of two integer tensors, the kernel's ``a`` and the
    reference ``b``; returns max |a - b| (0)."""
    require(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} != "
                                f"{tuple(b.shape)}")
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    require(err == 0, f"{what}: kernel differs from {ref} (max err {err})")
    return err


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------

def per_call_ms(rows, reps: int) -> dict:
    """Per-call device milliseconds of each profiler row ``(name, self
    device microseconds, recorded launches)``: the row's total over its own
    count of recorded launches, not over ``reps``.  Each kernel name of a
    run of ``reps`` calls (one launch per call) must have been recorded
    between ``reps // 2`` and ``reps`` times: a profile that dropped a few
    records still gives a true per-call time, while one that lost most of
    them or counted launches twice fails here."""
    out = {}
    for name, total_us, count in rows:
        require(reps // 2 <= count <= reps,
                f"profiler row {name!r}: {count} launches recorded for "
                f"{reps} calls (expected {reps // 2} to {reps})")
        out[name] = {"ms": total_us / count / 1e3, "launches": count}
    require(len(out) >= 1, "no profiler rows")
    return out


def check_reading(name: str, device_ms: float, bound: float,
                  ms: float | None = None, shape: str = "",
                  bound_by: str = "bytes") -> None:
    """Refuse a time under its bound: a kernel cannot move its bytes
    faster than the card's HBM peak, nor run its chain of dependent loads
    faster than one load's latency each, so such a reading is a broken
    measurement, not a result."""
    for what, t in (("device_ms", device_ms), ("ms", ms)):
        if t is not None:
            require(t >= bound, f"{name} ({shape}): {what} {t} is under its "
                                f"{bound_by} bound {bound} ms")


def kernel_device_split(fn, kernel, reps: int = 20,
                        attempts: int = 5) -> dict:
    """Device milliseconds per call and recorded launches of each device
    row (kernel, memset, copy) whose name contains ``kernel`` (a string, or
    a tuple of them), over ``reps`` calls after one warm-up, from
    torch.profiler: the kernels alone, without host gaps between launches.
    The profiler on the card sometimes loses records, down to a whole
    kernel's; such a profile is taken again, up to ``attempts`` times, and
    the last one must pass ``per_call_ms``'s count check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0
                and any(k in e.key for k in names)]
        if (all(any(k in r[0] for r in rows) for k in names)
                and all(reps // 2 <= r[2] <= reps for r in rows)):
            break
    missing = [k for k in names if not any(k in r[0] for r in rows)]
    require(not missing, f"no profiler rows for {missing} in {attempts} "
                         f"profiles")
    return per_call_ms(rows, reps)


def kernel_device_ms(fn, kernel, reps: int = 20) -> float:
    """The summed device time per call of ``kernel_device_split``."""
    split = kernel_device_split(fn, kernel, reps)
    return sum(r["ms"] for r in split.values())


def rank_packed_bytes(fused, blk, c, cut, sigma: int, bits: int) -> int:
    """``kernels/traffic.py`` ``rank_packed_bytes`` (the reckoning the kernel
    wrappers report to ``launch/roofline.py`` ``count``)."""
    from repro_torch.kernels.traffic import rank_packed_bytes

    return rank_packed_bytes(fused, blk, c, cut, sigma, bits)


def rank_select_bytes(blocks, blk, cut) -> int:
    """``kernels/traffic.py`` ``rank_select_bytes`` (the reckoning the kernel
    wrappers report to ``launch/roofline.py`` ``count``)."""
    from repro_torch.kernels.traffic import rank_select_bytes

    return rank_select_bytes(blocks, blk, cut)


def empty_launch_ms(chase) -> float:
    """Device milliseconds of a launch that does no work: the pointer
    chase ``chase`` at 0 steps (one thread writes one word), per recorded
    launch of the profiler (``kernel_device_ms``)."""
    import torch

    nxt = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def run():
        err = chase(nxt.data_ptr(), 0, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"pointer chase launch failed: CUDA error {err}")

    return kernel_device_ms(run, "chase_kernel")


def rank_floor(chase):
    """The single-batch rank kernels' latency floor over an operand of
    ``words`` int32 words, as a function of ``words``: one dependent load
    over them (``dependent_load_ns``: every query's row loads are issued
    together, so one round trip is the least a launch waits) plus an empty
    launch (``empty_launch_ms``, measured once here)."""
    empty = empty_launch_ms(chase)

    def floor(words: int) -> dict:
        lat = dependent_load_ns(chase, words)
        return dict(latency_ns=lat, empty_launch_ms=empty,
                    latency_floor_ms=lat / 1e6 + empty)

    return floor


def rank_calls(name: str, args: tuple, kw: dict) -> tuple:
    """(kernel call, plain call, bytes) of one batch of a single-batch rank
    kernel: ``rank_packed`` on (fused, blk, c, cut) with ``kw`` bits and
    sigma, or ``rank_select`` on (blocks, blk, c, cut)."""
    from repro_torch.kernels import rank_select as rk

    if name == "rank_packed":
        fused, blk, c, cut = args
        return (lambda: rk.rank_packed(*args, **kw),
                lambda: rk.rank_packed_plain(*args, **kw),
                rank_packed_bytes(fused, blk, c, cut, kw["sigma"],
                                  kw["bits"]))
    blocks, blk, c, cut = args
    return (lambda: rk.rank_select(*args),
            lambda: rk.rank_select_plain(*args),
            rank_select_bytes(blocks, blk, cut))


def warp_call(warp, args: tuple):
    """A call of the pre-redesign rank_select kernel (``warp``: the C
    entry of scripts/rank_select_warp.cu) on ``rank_select``'s arguments
    (blocks, blk, c, cut); each call returns its output."""
    import torch

    blocks, blk, c, cut = args
    out = torch.empty(blk.numel(), dtype=torch.int32, device=blk.device)

    def run():
        err = warp(blocks.data_ptr(), blocks.shape[1], blk.data_ptr(),
                   c.data_ptr(), cut.data_ptr(), out.data_ptr(), blk.numel(),
                   torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"rank_select_warp launch failed: CUDA error {err}")
        return out

    return run


def rank_select_groups(args: tuple) -> dict:
    """rank_select at every group size the plan can return on one batch
    (forced through ``launch_plan``): the plan's grid, registers and
    resident blocks beside the events ms (200 calls) and device ms."""
    from repro_torch.kernels import rank_select as rk

    out = {}
    for G in rk.GROUPS:
        plan = rk.launch_plan(args[0], args[1].numel(), G)

        def fn(plan=plan):
            return rk.rank_select_launch(*args, plan)

        occ = rk.rank_select_occupancy(args[0].device, G, plan["vector"])
        out[G] = {k: occ[k] for k in ("registers", "blocks_per_sm",
                                      "local_bytes")}
        out[G].update(grid=plan["grid"], ms=time_ms(fn, 200),
                      device_ms=kernel_device_ms(fn, "rank_select_kernel"))
    return out


def rank_row(name: str, args: tuple, kw: dict, shape: str, floor=None,
             plain_reps: int = 50, warp=None, stamps=None) -> dict:
    """One batch of a single-batch rank kernel on the card: equal to its
    plain version, its events ms (200 calls), device ms (profiler), bytes
    bound and plain ms, and with ``floor`` (``rank_floor``) its latency
    floor over the operand's words.  For rank_select also its plan (lanes
    a query, grid, loads, occupancy), every group size
    (``rank_select_groups``), with ``warp`` the pre-redesign kernel
    (scripts/rank_select_warp.cu) on the same batch (equal to the plain
    version, its device ms, and both L2-cold in turns: ``in_turns``), and
    with ``stamps`` both stamped (``rank_select_stamps``)."""
    from repro_torch.kernels import rank_select as rk

    fn, plain, nbytes = rank_calls(name, args, kw)
    want = plain()
    row = dict(max_abs_err=same(fn(), want, f"{name} ({shape})"),
               ms=time_ms(fn, 200), plain_ms=time_ms(plain, plain_reps),
               bound_ms=bound_ms(nbytes), library_ms=None, shape=shape,
               B=int(args[1].numel()))
    row["device_ms"] = kernel_device_ms(fn, f"{name}_kernel")
    if floor is not None:
        row.update(floor(args[0].numel()))
    if name == "rank_select":
        plan = row["plan"] = rk.launch_plan(args[0], row["B"])
        plan.update(rk.rank_select_occupancy(args[0].device, plan["group"],
                                             plan["vector"]))
        row["groups"] = rank_select_groups(args)
        if warp is not None:
            old = warp_call(warp, args)
            same(old(), want, f"pre-redesign rank_select ({shape})")
            row["before"] = dict(
                device_ms=kernel_device_ms(old, "rank_select_warp_kernel"),
                cold_in_turns_ms=in_turns({"old": old, "new": fn}))
        if stamps is not None:
            row["stamps"] = rank_select_stamps(stamps, args)
    return row


def rank_select_stamps(stamps, args: tuple) -> dict:
    """Where a rank_select launch of one batch (blocks, blk, c, cut; one
    resident wave) spends its time, by group size (0: the kernel before
    the redesign) from scripts/rank_select_stamps.cu: the median SM cycles
    of a query from its group's entry to its arguments' arrival, to its
    row's arrival and to its count, the median ns from entry to store, and
    the launch's span (first entry to last store, ns) and its entries'
    spread (first to last entry).  Each launch after one warm-up."""
    import torch

    from repro_torch.kernels import rank_select as rk

    blocks, blk, c, cut = args
    require(rk.vector_loads(blocks), "the stamped kernels take 16-byte "
            "aligned blocks of whole chunks only")
    B = blk.numel()
    out = torch.empty(B, dtype=torch.int32, device=blk.device)
    st = torch.zeros((B, 6), dtype=torch.int64, device=blk.device)
    rec = {}
    for group in (0, 4, 8, 16, 32, 104, 108, 116, 132):
        for _ in range(2):
            err = stamps(blocks.data_ptr(), blocks.shape[1], blk.data_ptr(),
                         c.data_ptr(), cut.data_ptr(), out.data_ptr(), B,
                         group, st.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"rank_select_stamps failed: CUDA error {err}")
        torch.cuda.synchronize()
        med = st.double().median(dim=0).values.tolist()
        rec["before" if group == 0 else f"G={group % 100}"
            + (" redux" if group > 100 else "")] = dict(
            args_cycles=med[0], row_cycles=med[1], sum_cycles=med[2],
            query_ns=float((st[:, 5] - st[:, 4]).double().median()),
            span_ns=int(st[:, 5].max() - st[:, 4].min()),
            entry_spread_ns=int(st[:, 4].max() - st[:, 4].min()))
    return rec


# phase 1's rank_select checks: block lengths (7: rows of whole 16-byte
# chunks never), batches of random queries, and the LF maps' batch of
# consecutive rows (merge (c)'s walked rows)
RANK_SELECT_R = (7, 32, 64, 128, 512)
RANK_SELECT_B = (1, 7, 1024, 16384)
LF_ROWS = 655360


def rank_select_checks(warp=None) -> dict:
    """rank_select equal to rank_select_plain at every group size the plan
    can return (forced through ``launch_plan``), and with ``warp`` the
    pre-redesign kernel too, over r in ``RANK_SELECT_R``, sigma 23 and 258,
    batches of ``RANK_SELECT_B`` random queries (a third at cut r, a third
    at cut 0, the first eight of each batch over blocks made all c) and
    ``LF_ROWS`` consecutive rows, each c the symbol at its row (the LF
    maps' batch), on 2^20-symbol blocks that start 16-byte aligned (the
    16-byte loads) and on a view 4 bytes off (the scalar loads)."""
    import torch

    from repro_torch.kernels import rank_select as rk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def rint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    cases = err = 0
    for r in RANK_SELECT_R:
        nb = (1 << 20) // r          # holds LF_ROWS rows at every r
        for sig in (23, 258):
            flat = rint(0, sig, nb * r + 1)
            for off in (0, 1):
                blocks = flat[off:off + nb * r].view(nb, r)
                batches = []
                for B in RANK_SELECT_B:
                    blk, c, cut = rint(0, nb, B), rint(0, sig, B), \
                        rint(0, r + 1, B)
                    cut[0::3], cut[1::3] = r, 0
                    blocks[blk[:8].long()] = c[:8, None]
                    batches.append((blk, c, cut))
                rows = torch.arange(LF_ROWS, dtype=torch.int32, device=dev)
                batches.append((rows // r, blocks.view(-1)[rows.long()],
                                rows % r))
                for blk, c, cut in batches:
                    what = (f"rank_select r={r} sigma={sig} offset={off} "
                            f"B={blk.numel()}")
                    want = rk.rank_select_plain(blocks, blk, c, cut)
                    for G in rk.GROUPS:
                        plan = rk.launch_plan(blocks, blk.numel(), G)
                        require(plan["vector"] == (off == 0 and r % 4 == 0),
                                f"{what}: vector loads {plan['vector']}")
                        err = max(err, same(rk.rank_select_launch(
                            blocks, blk, c, cut, plan), want,
                            f"{what} G={G}"))
                        cases += 1
                    if warp is not None:
                        same(warp_call(warp, (blocks, blk, c, cut))(), want,
                             f"pre-redesign {what}")
    return {"cases": cases, "max_abs_err": err, "r": RANK_SELECT_R,
            "B": [*RANK_SELECT_B, LF_ROWS], "groups": rk.GROUPS}


def phase_kernels(log2n_dna: int, chase=None, warp=None, stamps=None):
    """Phase 1's kernels against their plain versions; with ``chase``
    (``start_chase_build``) the single-batch rank kernels' latency floors:
    one dependent load over their operand's words (every query's row loads
    issued together) plus an empty launch.  rank_select also on
    ``rank_select_checks``' cases and, over the same operand, at the
    locate walk's 16,384 random queries and an LF map's 655,360
    consecutive rows; with ``warp`` beside the pre-redesign kernel, with
    ``stamps`` both stamped (``rank_select_stamps``)."""
    import torch

    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels import rank_select as rk
    from repro_torch.kernels import ops
    from repro_torch.kernels.radix_hist import (
        TILE,
        radix_hist,
        radix_hist_plain,
    )

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
    floor = rank_floor(chase) if chase is not None else None
    rows["rank_packed"] = rank_row(
        "rank_packed", (fused, blk, c, cut), dict(bits=bits, sigma=sigma),
        f"fused[{nb},{sigma + W}], B={blk.numel()}", floor)
    rows["rank_packed"]["max_abs_err"] = max(errs)
    del main

    # -- rank_select: unpacked blocks at sigma 258 (bytes) ------------------
    r, sig = 64, 258
    nb = (1 << 24) // r
    blocks = rint(0, sig, nb * r).view(nb, r)
    B = 1024
    blk, c, cut = rint(0, nb, B), rint(0, sig, B), rint(0, r + 1, B)
    cut[:8], cut[8:16] = 0, r
    blocks[blk[16:64].long()] = c[16:64, None]   # dense hits for some queries
    rows["rank_select"] = rank_row(
        "rank_select", (blocks, blk, c, cut), {},
        f"blocks[{nb},{r}], sigma={sig}, B={B}", floor, warp=warp,
        stamps=stamps)
    walk = (rint(0, nb, 16384), rint(0, sig, 16384), rint(0, r + 1, 16384))
    lf_rows = torch.arange(LF_ROWS, dtype=torch.int32, device=dev)
    lf = (lf_rows // r, blocks.view(-1)[lf_rows.long()], lf_rows % r)
    rows["rank_select"]["shapes"] = {
        name: rank_row("rank_select", (blocks, *q), {},
                       f"blocks[{nb},{r}], sigma={sig}, {name}", floor,
                       plain_reps=5, warp=warp, stamps=stamps)
        for name, q in (("B=16384", walk),
                        (f"B={LF_ROWS} consecutive rows", lf))}
    rows["rank_select"]["checks"] = rank_select_checks(warp)
    del blocks, blk, c, cut, walk, lf, lf_rows

    # -- radix hist / pos: parity sweeps at n = 2^22, at block 1024 (the
    #    JAX kernels' block) and at the sort engine's tile ---------------------
    n = 1 << 22
    uni = rint(-(1 << 31), (1 << 31) - 1, n)
    sweeps = {
        "uniform": uni,
        "all_equal": torch.full((n,), 0x5A3C96E1, dtype=torch.int32,
                                device=dev),
        "two_values": torch.where((uni & 1) == 0, 0x01010101,
                                  0x7F7F7F7F).to(torch.int32),
        "dna_like": rint(1, 5, n) * 0x01010101,   # 4 values in every digit
    }
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    herr = perr = radix_cases = 0
    for block in (1024, TILE):
        for name, keys in sweeps.items():
            for shift in (0, 8, 16, 24):
                what = f"{name} shift={shift} block={block}"
                h = radix_hist(keys, shift, block=block)
                herr = max(herr, same(h, radix_hist_plain(keys, shift,
                                                          block=block),
                                      f"radix_hist {what}"))
                base = rs.digit_major_bases(h)
                want = rs.radix_pos_plain(keys, base, shift, block=block)
                for b in (base, base.contiguous()):   # both base layouts
                    perr = max(perr, same(rs.radix_pos(keys, b, shift,
                                                       block=block),
                                          want, f"radix_pos {what}"))
                # the fused scatter of four operands, the key word among them
                operands = (pay, keys, pay ^ keys, pay.flip(0))
                outs = tuple(torch.empty_like(a) for a in operands)
                rs.radix_scatter(keys, base, shift, operands, outs,
                                 block=block)
                for k, (a, got) in enumerate(zip(operands, outs)):
                    expect = torch.empty_like(a)
                    expect[want.long()] = a
                    perr = max(perr, same(got, expect,
                                          f"radix_scatter {what} op {k}"))
                radix_cases += 1
    cases = []
    for bits_ in (29, 17, 32):                       # single word
        k = rint(-(1 << 31), (1 << 31) - 1, n)
        if bits_ < 32:
            k = k & ((1 << bits_) - 1)
        cases.append(((k, pay), 1, (bits_,)))
    cases.append(((rint(0, 7, n), rint(0, 11, n), pay), 2, (3, 4)))  # ties
    m = n - 500                                       # forces tile padding
    sat = torch.full((m,), (1 << 12) - 1, dtype=torch.int32, device=dev)
    cases.append(((sat, pay[:m]), 1, (12,)))          # saturated + pads
    for operands, nk, kb in cases:
        want = ops.local_sort(operands, nk, engine=ops.COMPARE)
        for got in (ops.radix_sort(operands, num_keys=nk, key_bits=kb),
                    rs.radix_sort_blocked(operands, nk, kb, block=1024)):
            for x, y in zip(got, want):
                perr = max(perr, same(x, y, f"radix_sort key_bits={kb}"))
            if operands[0] is sat:
                require(bool((got[1] == pay[:m]).all()), "saturated keys moved")
            radix_cases += 1
    del sweeps, uni, cases, got, want, operands, outs

    # -- radix timing at the main path's size: uniform keys, 3 operands -----
    keys, ops3 = uniform_operands(n_main, g)
    hrow, prow = radix_rows(keys, ops3, f"uniform keys[{keys.shape[0]}]")
    hrow["max_abs_err"] = max(herr, hrow["max_abs_err"])
    prow["max_abs_err"] = max(perr, prow["max_abs_err"])
    prow["sweep_cases"] = radix_cases
    rows["radix_hist"], rows["radix_pos"] = hrow, prow
    del keys, ops3
    torch.cuda.empty_cache()
    return rows


def pad_to_tiles(a, value: int):
    """``a`` followed by ``value`` up to a multiple of the sort engine's
    tile (a multiple of every radix tile), as the engine pads
    (field-limited pads sort last)."""
    import torch

    from repro_torch.kernels.radix_hist import TILE

    pad = (-a.shape[0]) % TILE
    return torch.cat([a, torch.full((pad,), value, dtype=a.dtype,
                                    device=a.device)])


def uniform_operands(n: int, g):
    """Uniform random 32-bit keys at ``n`` (padded to the sort engine's
    tile) and the three operands of the q-gram init's first pass: the key
    word, a second word and the index."""
    import torch

    from repro_torch.kernels.radix_hist import TILE

    dev = g.device
    nr = n + (-n) % TILE
    keys = torch.randint(-(1 << 31), (1 << 31) - 1, (nr,), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)
    second = torch.randint(0, 1 << 30, (nr,), generator=g, device=dev,
                           dtype=torch.int64).to(torch.int32)
    return keys, (keys, second, torch.arange(nr, dtype=torch.int32,
                                             device=dev))


def qgram_operands(s_dev, sigma: int):
    """The q-gram init's real first pass on the prepared text ``s_dev``:
    key word 1 of the two-word q-gram keys, over the operands (k0, k1,
    idx), padded as the sort engine pads."""
    import torch

    from repro_torch.core import keypack
    from repro_torch.kernels.radix_sort import _pad_value

    _, fpw, bits = keypack.qgram_params(sigma, 2)
    k0, k1 = keypack.qgram_keys_local(s_dev, fpw, bits, 2)
    kpad = _pad_value(min(32, fpw * bits))
    idx = torch.arange(s_dev.shape[0], dtype=torch.int32, device=s_dev.device)
    ops3 = (pad_to_tiles(k0, kpad), pad_to_tiles(k1, kpad),
            pad_to_tiles(idx, 0))
    return ops3[1], ops3


def radix_rows(keys, operands, what: str) -> tuple[dict, dict]:
    """radix_hist and the fused radix_scatter of ``operands`` (the key word
    among them) at shift 0 and the sort engine's tile, against their plain
    versions, timed beside their bounds and yardsticks (``bincount`` of
    the (tile, digit) cells; a stable ``torch.sort`` of the digit).  The
    scatter's row also carries one whole digit pass (hist + bases +
    scatter) and the kernel's device time with only its rank phase (no
    operand), with the positions written instead of the operands, and
    with one digit in every key (one run per tile)."""
    import torch

    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels.radix_hist import (
        TILE,
        radix_hist,
        radix_hist_plain,
    )

    nr, k = keys.shape[0], len(operands)
    ntiles = nr // TILE
    outs = tuple(torch.empty_like(a) for a in operands)
    h = radix_hist(keys, 0, block=TILE)
    herr = same(h, radix_hist_plain(keys, 0, block=TILE),
                f"radix_hist {what}")
    base = rs.digit_major_bases(h)
    rs.radix_scatter(keys, base, 0, operands, outs, block=TILE)
    want = tuple(torch.empty_like(a) for a in operands)
    rs.radix_scatter_plain(keys, base, 0, operands, want, block=TILE)
    perr = max(same(x, y, f"radix_scatter {what} operand {i}")
               for i, (x, y) in enumerate(zip(outs, want)))
    del want

    def hist():
        return radix_hist(keys, 0, block=TILE)

    def scatter():
        rs.radix_scatter(keys, base, 0, operands, outs, block=TILE)

    def digit_pass():
        b = rs.digit_major_bases(radix_hist(keys, 0, block=TILE))
        rs.radix_scatter(keys, b, 0, operands, outs, block=TILE)

    cell = (torch.arange(nr, device=keys.device) // TILE) * 256 + (keys & 0xFF)
    hrow = dict(
        max_abs_err=herr, ms=time_ms(hist, 10),
        plain_ms=time_ms(lambda: radix_hist_plain(keys, 0, block=TILE), 3),
        bound_ms=bound_ms(4 * nr + ntiles * 256 * 4),
        library_ms=time_ms(lambda: torch.bincount(
            cell, minlength=ntiles * 256), 3),
        device_ms=kernel_device_ms(hist, "radix_hist_kernel"),
        shape=f"{what}, tile={TILE}")
    del cell
    digits = keys & 0xFF
    one = torch.zeros_like(keys)
    one_base = rs.digit_major_bases(radix_hist(one, 0, block=TILE))
    prow = dict(
        max_abs_err=perr, ms=time_ms(scatter, 10),
        plain_ms=time_ms(lambda: rs.radix_scatter_plain(
            keys, base, 0, operands, outs, block=TILE), 3),
        # each operand read and written once (the key word is one of them)
        # and one 256-entry base row per tile
        bound_ms=bound_ms(ntiles * 256 * 4 + 8 * nr * k),
        library_ms=time_ms(lambda: torch.sort(digits, stable=True), 3),
        device_ms=kernel_device_ms(scatter, "radix_pos_kernel"),
        device_ms_rank_only=kernel_device_ms(
            lambda: rs.radix_scatter(keys, base, 0, (), (), block=TILE),
            "radix_pos_kernel"),
        device_ms_positions=kernel_device_ms(
            lambda: rs.radix_pos(keys, base, 0, block=TILE),
            "radix_pos_kernel"),
        # the same pass with one digit everywhere: one run per tile
        device_ms_one_digit=kernel_device_ms(
            lambda: rs.radix_scatter(one, one_base, 0, (one, *operands[1:]),
                                     outs, block=TILE),
            "radix_pos_kernel"),
        digit_pass=dict(ms=time_ms(digit_pass, 10),
                        device_ms=kernel_device_ms(digit_pass, ""),
                        bound_ms=bound_ms(8 * nr * k)),
        shape=f"{what}, {k} operands scattered, tile={TILE}")
    del one, one_base
    return hrow, prow


def hist_row(tokens, sigma: int, what: str) -> dict:
    """char_histogram against its plain version on ``tokens``, timed beside
    its bound (each token read once) and ``torch.bincount``."""
    import torch

    from repro_torch.kernels.char_histogram import (
        char_histogram,
        char_histogram_plain,
    )

    err = same(char_histogram(tokens, sigma),
               char_histogram_plain(tokens, sigma), f"char_histogram {what}")
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: char_histogram(tokens, sigma), 20),
        plain_ms=time_ms(lambda: char_histogram_plain(tokens, sigma), 3),
        bound_ms=bound_ms(4 * tokens.numel() + 4 * sigma),
        library_ms=time_ms(lambda: torch.bincount(tokens, minlength=sigma),
                           3),
        device_ms=kernel_device_ms(lambda: char_histogram(tokens, sigma),
                                   "char_histogram_kernel"),
        shape=f"{what}: tokens[{tokens.numel()}], sigma={sigma}")


def check_rerank(r1, r2, what: str) -> tuple[int, int]:
    """rerank_scan against its plain version on the card: ranks and group
    count must be equal; returns (max abs error (0), groups)."""
    from repro_torch.kernels.rerank_scan import rerank_scan, rerank_scan_plain

    got_r, got_g = rerank_scan(r1, r2)
    want_r, want_g = rerank_scan_plain(r1, r2)
    err = same(got_r, want_r, f"rerank_scan ranks {what}")
    require(int(got_g) == int(want_g),
            f"rerank_scan groups {what}: {int(got_g)} != {int(want_g)}")
    return err, int(want_g)


def rerank_shape(r1, r2, what: str, reps: int = 20) -> dict:
    """One timed shape of rerank_scan: exact parity with its plain version,
    event time, device time of its one kernel (the scratch memset listed
    beside it), the bytes bound (12n, or 8n when ``r2`` is ``r1``) and
    ``ceiling_ms``, the event time of ``torch.add(r1, r2, out=buf)``: a
    streaming pass over the same bytes, the rate this card really gives (a
    yardstick only; no PyTorch call computes re-rank)."""
    import torch

    from repro_torch.kernels.rerank_scan import rerank_scan

    n = r1.shape[0]
    aliased = r1.data_ptr() == r2.data_ptr()
    err, groups = check_rerank(r1, r2, what)

    def call():
        rerank_scan(r1, r2)

    split = kernel_device_split(call, ("rerank_kernel", "Memset"), reps)
    kern = [k for k in split if "rerank_kernel" in k]
    require(len(kern) == 1, f"rerank_scan {what}: kernels {sorted(split)}")
    buf = torch.empty_like(r1)
    rec = dict(n=n, aliased=aliased, groups=groups, max_abs_err=err,
               ms=time_ms(call, reps), device_ms=split[kern[0]]["ms"],
               bound_ms=bound_ms((8 if aliased else 12) * n + 4),
               ceiling_ms=time_ms(lambda: torch.add(r1, r2, out=buf), reps),
               profiler_rows=split, shape=what)
    check_reading("rerank_scan", rec["device_ms"], rec["bound_ms"],
                  rec["ms"], what)
    return rec


def phase_build_kernels(dna_toks) -> dict:
    """rerank_scan and char_histogram against their plain versions: at the
    main path's shapes (the sorted q-gram key words and the prepared text of
    DNA 2^28, the seed builder's first-round pairs) and on edge sweeps."""
    import torch

    from repro_torch.core import keypack
    from repro_torch.core.pipeline import prepare_tokens
    from repro_torch.core.suffix_array import initial_ranks, shifted_ranks
    from repro_torch.kernels import ops
    from repro_torch.kernels.char_histogram import (
        char_histogram,
        char_histogram_plain,
    )
    from repro_torch.kernels.rerank_scan import TILE, rerank_scan_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    big = (1 << 31) - 1

    def rint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def at_offset(a, off: int):
        """``a`` copied to a contiguous slice starting ``off`` words into
        its buffer (a start that is only 4-byte aligned for off 1-3)."""
        buf = torch.empty(a.shape[0] + off, dtype=a.dtype, device=dev)
        buf[off:] = a
        return buf[off:]

    # -- rerank_scan: edge sweep ---------------------------------------------
    rerr, cases = 0, 0
    for n in (1, 2, 2047, 2048, 2049, 5000, TILE - 1, TILE, TILE + 1,
              3 * TILE + 5, (1 << 20) + 3):
        rand = torch.sort(rint(0, 50, n)).values
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        step = torch.arange(n, device=dev)
        sweep = {
            "all_equal": (zeros, zeros.clone()),
            "all_distinct": (step.to(torch.int32), zeros),
            "random_sorted": (rand, zeros),
            # runs of 97 start inside the row before a tile, runs of 3000
            # cross every 2048-pair edge, runs of 3 tiles leave whole tiles
            # without a head
            "short_runs": ((step // 97).to(torch.int32), zeros),
            "long_runs": ((step // 3000).to(torch.int32), zeros),
            "runs_3_tiles": ((step // (3 * TILE)).to(torch.int32), zeros),
        }
        r1, r2 = rand.clone(), rint(-1, 3, n)
        key = r1.long() * 8 + r2.long() + 1          # lexicographic order
        order = torch.sort(key, stable=True).indices
        sweep["random_pairs"] = (r1[order], r2[order])
        tail = torch.arange(n, dtype=torch.int32, device=dev)
        tail[-3:] = big
        sweep["int32_max_tail"] = (tail, tail.clone())
        if n > TILE:                     # an INT32_MAX group across an edge
            edge = torch.arange(n, dtype=torch.int32, device=dev)
            edge[TILE - 2:] = big
            sweep["int32_max_tile_edge"] = (edge, edge.clone())
        for name, (a, b) in sweep.items():
            rerr = max(rerr, check_rerank(a, b, f"{name} n={n}")[0])
            # r2 aliasing r1 (the fast rounds' re-rank by r1 alone)
            rerr = max(rerr, check_rerank(a, a, f"{name} aliased n={n}")[0])
            cases += 2
        # starts at storage offsets 1-3 (only 4-byte aligned), one operand
        # or both, and aliased
        a, b = sweep["random_pairs"]
        for off in (1, 2, 3):
            ma, mb = at_offset(a, off), at_offset(b, (off + 1) % 4)
            for x, y, tag in ((ma, b, "r1"), (a, mb, "r2"), (ma, mb, "both"),
                              (ma, ma, "aliased")):
                rerr = max(rerr, check_rerank(
                    x, y, f"random_pairs offset {off} ({tag}) n={n}")[0])
                cases += 1
    # all-equal 2^24: every tile but the first has no head and looks back
    # to tile 0
    n = 1 << 24
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    for b in (zeros.clone(), zeros):
        rerr = max(rerr, check_rerank(zeros, b, f"all_equal n={n}")[0])
        cases += 1
    del zeros, sweep, rand, step, key, order, r1, r2, tail, a, b, ma, mb

    # -- rerank_scan: the q-gram init's sorted key words (DNA 2^28) ----------
    s, sigma = prepare_tokens(dna_toks, 64)
    s_dev = torch.as_tensor(s, device=dev)
    del s
    nq = s_dev.shape[0]
    _, fpw, bits = keypack.qgram_params(sigma, 2)
    keys = keypack.qgram_keys_local(s_dev, fpw, bits, 2)
    k0, k1, _ = ops.local_sort(
        (*keys, torch.arange(nq, dtype=torch.int32, device=dev)), 2,
        engine=ops.RADIX, key_bits=(min(32, fpw * bits),) * 2)
    del keys
    tag = f"DNA n={len(dna_toks)}"
    shapes = {
        "qgram_words": rerank_shape(k0, k1, f"sorted q-gram words k0,k1[{nq}] "
                                            f"({tag})"),
        "qgram_aliased": rerank_shape(k0, k0, f"q-gram word k0 aliased "
                                              f"[{nq}] ({tag})"),
    }
    plain_ms = time_ms(lambda: rerank_scan_plain(k0, k1), 3)
    del k0, k1
    torch.cuda.empty_cache()
    # -- the seed builder's first-round pairs: groups span many tiles -------
    rank = initial_ranks(s_dev, sigma)
    r2 = shifted_ranks(rank, 1)
    perm = torch.sort(r2, stable=True).indices
    perm = perm[torch.sort(rank[perm], stable=True).indices]
    p1, p2 = rank[perm], r2[perm]
    del rank, r2, perm
    torch.cuda.empty_cache()
    shapes["seed_round1"] = rerank_shape(
        p1, p2, f"seed builder round-1 pairs [{nq}] ({tag})")
    del p1, p2
    zeros = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    shapes["all_equal"] = rerank_shape(zeros, zeros.clone(),
                                       f"all-equal pairs [{1 << 28}]")
    del zeros
    small = torch.sort(rint(0, 1 << 12, 1 << 14)).values
    shapes["small"] = rerank_shape(small, rint(0, 4, 1 << 14),
                                   f"random pairs [{1 << 14}] (fast-round "
                                   f"scale)")
    for rec in shapes.values():
        rerr = max(rerr, rec["max_abs_err"])
    main = shapes["qgram_words"]
    rows = {"rerank_scan": dict(
        max_abs_err=rerr, ms=main["ms"], plain_ms=plain_ms,
        bound_ms=main["bound_ms"], library_ms=None,
        device_ms=main["device_ms"], ceiling_ms=main["ceiling_ms"],
        groups=main["groups"], sweep_cases=cases, tile=TILE, shapes=shapes,
        shape=main["shape"])}
    torch.cuda.empty_cache()

    # -- radix hist / pos at the q-gram init's real first pass -------------
    qkeys, q3 = qgram_operands(s_dev, sigma)
    rows["radix_qgram"] = radix_rows(
        qkeys, q3, f"DNA n={len(dna_toks)} q-gram word 1 [{qkeys.shape[0]}]")
    del qkeys, q3
    torch.cuda.empty_cache()

    # -- char_histogram: sigma sweep with out-of-range values, then the text -
    herr = 0
    for sig in (7, 23, 258):
        for n in (1, 100, 1025, (1 << 24) + 17):
            toks = rint(-2, sig + 3, n)
            herr = max(herr, same(char_histogram(toks, sig),
                                  char_histogram_plain(toks, sig),
                                  f"char_histogram sigma={sig} n={n}"))
    row = hist_row(s_dev, sigma, f"DNA n={len(dna_toks)} prepared text")
    row["max_abs_err"] = max(row["max_abs_err"], herr)
    rows["char_histogram"] = row
    del s_dev
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phases 2-3: the main path at full size
# --------------------------------------------------------------------------

def sample_patterns(toks, count: int, seed: int, lo: int = 3, hi: int = 32):
    """``count`` substrings of ``toks`` of lengths uniform in [lo, hi]."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5E7]))
    out = []
    for _ in range(count):
        L = int(rng.integers(lo, hi + 1))
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


def profiled(fn, watch=()) -> dict:
    """Run ``fn`` once under torch.profiler (CPU + CUDA activities): wall
    seconds, device-busy share (summed self device time over wall; the
    profiler's own host overhead inflates the wall), the top device time
    by kernel/op name and, under ``watched``, every device row whose name
    contains one of ``watch``."""
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
            "device_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:48], "device_ms": d / 1e3, "calls": c}
                    for d, k, c in rows[:12]],
            "watched": [{"name": k[:48], "device_ms": d / 1e3, "calls": c}
                        for d, k, c in rows if any(w in k for w in watch)]}


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


def phase_main(kind: str, toks, gen_s: float, phase: int, keep: bool,
               snap: bool = False, chase=None):
    """One main path; returns its launches, with ``keep`` what later phases
    compare against (the index, its requests and answers), the fused
    query kernel's parity and times on the path's index (with ``chase``,
    ``start_chase_build``, beside their latency floors) and, with
    ``snap``, phase 10's reference (``snapshot``)."""
    import functools

    import torch

    from repro_torch.configs.bwt_index import CONFIG as icfg
    from repro_torch.core.pipeline import SAConfig, build_index, prepare_tokens
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import FMQueryServer

    n = len(toks)
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
    # the serving part of the path: one fused launch per (kind, bucket)
    # batch, no single-batch rank kernel
    serve = {k: launches[k] - build_launches[k] for k in launches}
    batches = server.stats.batches
    qname = query_fns(index.fm)[0]
    require(serve[qname] == batches,
            f"phase {phase}: {serve[qname]} {qname} launches for {batches} "
            f"batches")
    require(serve["rank_packed"] == 0 and serve["rank_select"] == 0,
            f"phase {phase}: a rank kernel launched while serving: {serve}")

    # after the counted run, so these launches are not counted
    extra = {
        "stages_s": stage_times(toks, 64, 32),
        "profile_build": profiled(lambda: build_index(
            toks, sample_rate=64, sa_sample_rate=32, device="cuda"),
            watch=BUILD_WATCH),
        "profile_count": profiled(lambda: server.count(pats)),
        "profile_locate": profiled(lambda: server.locate(pats)),
    }

    fq = {"name": qname, "index": f"{kind} n={n}"}
    fq["max_abs_err"] = check_queries(index.fm, query_cases(
        index.fm, toks, pats, phase), fq["index"])
    fq.update(query_timing(index.fm, toks, pats, phase, functools.lru_cache(
        maxsize=None)(functools.partial(dependent_load_ns, chase))
        if chase is not None else None))

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
          "launches": launches, "launches_serve": serve,
          "serve_batches": batches, "fm_query": fq,
          "sa_check": "pass",
          "count_check": "64 brute force + 1024 locate-consistent",
          "locate_check": f"{sum(len(p) for p in located)} positions",
          **extra})
    del server, toks_dev
    kept = dict(index=index, pats=pats, counts=counts, located=located,
                build_s=build_s) if keep else None
    ref = snapshot(index, pats) if snap else None
    del index
    torch.cuda.empty_cache()
    return launches, kept, fq, ref


# --------------------------------------------------------------------------
# the fused query kernels: parity, times, bounds (phases 1-3)
# --------------------------------------------------------------------------

def query_fns(fm):
    """(kernel name, wrapper, plain version, single-batch rank kernel
    wrapper) of the index's layout."""
    from repro_torch.kernels import fm_query as fq
    from repro_torch.kernels import rank_select as rk

    if fm.bits:
        return ("fm_query_packed", fq.fm_query_packed,
                fq.fm_query_packed_plain, rk.rank_packed)
    return ("fm_query_unpacked", fq.fm_query_unpacked,
            fq.fm_query_unpacked_plain, rk.rank_select)


def pad_patterns(pats, L: int, device, B: int | None = None):
    """int32[B, L] PAD-padded patterns (rows past len(pats) all PAD)."""
    import numpy as np
    import torch

    from repro_torch.core.fm_index import PAD

    out = np.full((B or len(pats), L), PAD, np.int32)
    for i, p in enumerate(pats):
        out[i, : len(p)] = p
    return torch.from_numpy(out).to(device)


def flush_buckets(pats, device):
    """The requests grouped as ``FMQueryServer.flush`` groups them under
    the config's buckets: one PAD-padded batch per length bucket, its rows
    rounded up to a power of two."""
    from repro_torch.configs.bwt_index import CONFIG as icfg

    groups = {}
    for p in pats:
        L = next(b for b in icfg.serve_length_buckets if len(p) <= b)
        groups.setdefault(L, []).append(p)
    return [pad_patterns(ps, L, device, min(1 << (len(ps) - 1).bit_length(),
                                            icfg.serve_max_batch))
            for L, ps in sorted(groups.items())]


def edge_patterns(toks, sigma: int, seed: int):
    """All-PAD, every length-1 pattern, lengths 64 and 128 from the text,
    the sentinel 0, symbols at and past sigma and a negative one inside a
    pattern, a PAD inside a pattern, and random (absent) patterns."""
    import numpy as np

    from repro_torch.core.fm_index import PAD

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xED6]))

    def cut(L):
        st = int(rng.integers(0, len(toks) - L))
        return toks[st: st + L].copy()

    out = [np.zeros(0, np.int32), np.array([0], np.int32)]
    out += [np.array([c], np.int32) for c in range(1, sigma)]
    out += [cut(64), cut(64), cut(128), cut(128)]
    for bad in (0, sigma, sigma + 5, 999, -2, PAD):
        p = cut(12)
        p[5] = bad
        out.append(p)
    out += [rng.integers(1, sigma, 40).astype(np.int32) for _ in range(8)]
    return out


def query_cases(fm, toks, pats, seed: int):
    """(what, patterns, k): the requests batched as the server batches
    them, for count and locate, and the edge patterns at k = 0, 1, 16, 64
    (64 is past the occurrences of every long pattern)."""
    cases = []
    for P in flush_buckets(pats, fm.device):
        cases += [(f"requests m={P.shape[1]}", P, k) for k in (0, LOCATE_K)]
    E = pad_patterns(edge_patterns(toks, fm.sigma, seed), 128, fm.device)
    return cases + [("edge", E, k) for k in (0, 1, LOCATE_K, 64)]


def check_queries(fm, cases, what: str) -> int:
    """Every case through the layout's fused kernel and its plain version
    on the card: sp, ep and the positions must be equal; returns the max
    abs error (0)."""
    name, kern, plain, _ = query_fns(fm)
    err = 0
    for case, P, k in cases:
        got, want = kern(fm, P, k), plain(fm, P, k)
        tag = f"{name} {what} {case} k={k}"
        err = max(err, same(got[0], want[0], f"{tag} sp"),
                  same(got[1], want[1], f"{tag} ep"))
        if k:
            err = max(err, same(got[2], want[2], f"{tag} positions"))
    return err


def small_index_checks() -> tuple[dict, list]:
    """The fused kernels against their plain versions on a 2-bit index at
    n = 2^20 over tokens {1, 2, 3}, with raw and bit-packed SA values;
    on the same BWT also with 512-symbol blocks (rows of 32 packed words)
    and unpacked at r = 64 and 128.  Returns (max error per kernel, the
    layouts checked)."""
    import numpy as np
    import torch

    from repro_torch.core import alphabet as al
    from repro_torch.core.bwt import bwt_from_sa
    from repro_torch.core.fm_index import build_fm_index
    from repro_torch.core.suffix_array import suffix_array_fast

    rng = np.random.default_rng(np.random.SeedSequence([20, 0x2B1]))
    toks = rng.integers(1, 4, 1 << 20).astype(np.int32)
    s = al.append_sentinel(toks)
    sigma = al.sigma_of(s)
    s_dev = torch.as_tensor(s, device="cuda")
    sa, _ = suffix_array_fast(s_dev, sigma, local_sort="auto")
    bwt, row = bwt_from_sa(s_dev, sa)
    pats = sample_patterns(toks, 1024, seed=7)
    errs = {"fm_query_packed": 0, "fm_query_unpacked": 0}
    layouts = []
    for r, pack in ((64, None), (512, None), (64, False), (128, False)):
        for compress in (False, True):
            fm = build_fm_index(bwt, row, sigma, r, sa=sa, sa_sample_rate=32,
                                pack=pack, compress_sa=compress)
            require((fm.sa_val_bits > 0) == compress, "SA value encoding")
            name = query_fns(fm)[0]
            what = (f"sigma={sigma} r={r} bits={fm.bits} "
                    f"val_bits={fm.sa_val_bits}")
            errs[name] = max(errs[name], check_queries(
                fm, query_cases(fm, toks, pats, r), what))
            layouts.append(f"{name}: {what}")
    return errs, layouts


def query_bytes(fm, P, k: int) -> tuple[int, int]:
    """``kernels/traffic.py`` ``query_bytes`` (the reckoning the kernel
    wrappers report to ``launch/roofline.py`` ``count``)."""
    from repro_torch.kernels.traffic import query_bytes

    return query_bytes(fm, P, k)


def query_timing(fm, toks, pats, seed: int, latency_ns=None) -> dict:
    """Per length bucket (B = 1024 requests of lengths in the bucket, count
    and locate): the fused kernel's event and device times beside its
    bound and dependent steps (with ``latency_ns(words)`` also its latency
    floor, ``latency_floor``), the plain version, and the earlier design
    (the same step loop launching the single-batch rank kernel); then the
    earlier design against the fused kernel over the flush's own batches,
    timed in turns (old, new, new, old)."""
    name, kern, plain, rank_kernel = query_fns(fm)
    dev = fm.device
    buckets = []
    for L, lo in ((8, 3), (16, 9), (32, 17)):
        P = pad_patterns(sample_patterns(toks, 1024, seed, lo, L), L, dev)
        for k in (0, LOCATE_K):
            nbytes, walk = query_bytes(fm, P, k)
            buckets.append(dict(
                m=L, B=1024, k=k,
                ms=time_ms(lambda: kern(fm, P, k), 20),
                device_ms=kernel_device_ms(lambda: kern(fm, P, k),
                                           f"{name}_kernel"),
                plain_ms=time_ms(lambda: plain(fm, P, k), 3),
                old_ms=time_ms(lambda: plain(fm, P, k, rank=rank_kernel), 3),
                bound_ms=bound_ms(nbytes), bytes=nbytes,
                dependent_steps={"search": L, "walk": walk},
                **(latency_floor(fm, P, walk, latency_ns)
                   if latency_ns is not None else {})))
    reqs = flush_buckets(pats, dev)

    def old():
        for P in reqs:
            for k in (0, LOCATE_K):
                plain(fm, P, k, rank=rank_kernel)

    def new():
        for P in reqs:
            for k in (0, LOCATE_K):
                kern(fm, P, k)

    turns = {"old": [], "new": []}
    for tag, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        turns[tag].append(time_ms(fn, 3))
    return {"buckets": buckets, "turns_ms": turns,
            "flush_batches": [list(P.shape) for P in reqs]}


def query_row(rec: dict, small_err: int) -> dict:
    """The kernels-line row of a fused kernel: its locate bucket at m = 32
    (the largest launch of the main path)."""
    top = next(b for b in rec["buckets"] if b["m"] == 32 and b["k"])
    return dict(max_abs_err=max(rec["max_abs_err"], small_err),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], library_ms=None,
                device_ms=top["device_ms"],
                dependent_steps=top["dependent_steps"],
                **{k: top[k] for k in ("latency_floor_ms",) if k in top},
                shape=f"{rec['index']}: locate B=1024, m=32, k={LOCATE_K}")


# --------------------------------------------------------------------------
# phase 4: CPU (plain) vs CUDA (kernels) parity
# --------------------------------------------------------------------------

def api_parity(toks, cpu, dev) -> tuple[dict, dict]:
    """The index's single-query functions on ``dev`` (a ``SequenceIndex``
    on the card) against ``cpu`` (the same index on the CPU): ``occ``,
    ``backward_search``, ``bwt_symbol`` and ``locate_naive`` through the
    single-batch rank kernels, then ``suffix_array_rpgi`` / ``bwt_rpgi``
    of the first 4096 tokens against the fast build.  Returns (record,
    launches of the calls on ``dev``)."""
    import numpy as np
    import torch

    from repro_torch.core import alphabet as al
    from repro_torch.core import fm_index as fm
    from repro_torch.core.competitor import bwt_rpgi, suffix_array_rpgi
    from repro_torch.core.suffix_array import suffix_array_fast

    pats = [p[:12] for p in sample_patterns(toks, 16, seed=41)]
    pats.append(np.array([1, 999, 2], np.int32))     # out of the alphabet
    rng = np.random.default_rng(41)
    cs = rng.integers(0, cpu.fm.sigma, 64).astype(np.int32)
    ps = rng.integers(0, cpu.fm.n + 1, 64).astype(np.int32)
    rows = torch.from_numpy(rng.integers(0, cpu.fm.n, 4096).astype(np.int32))

    def answers(index):
        f, d = index.fm, index.fm.device
        out = [fm.backward_search(f, p) for p in pats]
        out += [fm.occ(f, torch.tensor(c, device=d), torch.tensor(p, device=d))
                for c, p in zip(cs, ps)]
        out.append(fm.bwt_symbol(f, rows.to(d)))
        out += [fm.locate_naive(f, index.sa, p) for p in pats[:4]]
        return out

    _counts_reset()
    got = answers(dev)
    launches, _ = _counts()
    want = answers(cpu)
    for i, (a, b) in enumerate(zip(got, want)):
        a = torch.stack(a) if isinstance(a, tuple) else a
        b = torch.stack(b) if isinstance(b, tuple) else b
        same(a.cpu(), b, f"single-query answer {i}", ref="the CPU")
    rank = "rank_packed" if cpu.fm.bits else "rank_select"
    if dev.fm.device.type == "cuda":
        require(launches[rank] > 0 and not launches["fm_query_packed"]
                and not launches["fm_query_unpacked"],
                f"single-query functions: launches {launches}")
    s = al.append_sentinel(toks[:4096])
    sa_fast, _ = suffix_array_fast(torch.from_numpy(s), al.sigma_of(s))
    for device in ("cpu", dev.fm.device):
        sd = torch.from_numpy(s).to(device)
        same(suffix_array_rpgi(sd).cpu(), sa_fast, f"rpgi SA on {device}",
             ref="the fast build")
        b, r = bwt_rpgi(sd)
        same(b.cpu(), sd.cpu()[(sa_fast.long() - 1) % len(s)],
             f"rpgi BWT on {device}", ref="the fast build's")
    return {"patterns": len(pats), "occ": len(cs), "rank_kernel": rank,
            "rank_launches": launches[rank], "rpgi_n": len(s)}, launches


def phase_parity(log2n: int):
    import numpy as np
    import torch

    from repro_torch.core.fm_index import PAD, fm_mismatch
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus

    out, launches = {}, {}
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
        # the seed builder on both devices: the same index again
        for dev in ("cpu", "cuda"):
            seed = build_index(toks, device=dev, fast=False)
            require(torch.equal(cpu.sa, seed.sa.cpu()),
                    f"{kind}: seed SA on {dev} differs")
            mm = fm_mismatch(cpu.fm, seed.fm)
            require(mm == [], f"{kind}: seed FMIndex on {dev} differs: {mm}")
            require(torch.equal(cpu.count(pats), seed.count(pats).cpu()),
                    f"{kind}: seed counts on {dev} differ")
        out[kind] = {"sigma": cpu.sigma, "bits": cpu.fm.bits,
                     "engines": engines, "builders": ["fast", "seed"],
                     "identical": True}
        out[kind]["single_query"], launches[kind] = api_parity(toks, cpu, gpu)
    return out, launches


# --------------------------------------------------------------------------
# phase 5: the seed builder at full size
# --------------------------------------------------------------------------

def phase_seed(dna_toks, kept) -> dict:
    import torch

    from repro_torch.core.fm_index import fm_mismatch
    from repro_torch.core.pipeline import build_index
    from repro_torch.kernels import _build

    fast = kept["index"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    seed = build_index(dna_toks, sample_rate=64, sa_sample_rate=32,
                       fast=False, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(torch.equal(seed.sa, fast.sa), "seed SA != fast SA")
    require(torch.equal(seed.bwt, fast.bwt), "seed BWT != fast BWT")
    require(int(seed.row) == int(fast.row), "seed row != fast row")
    mm = fm_mismatch(seed.fm, fast.fm)
    require(mm == [], f"seed FMIndex differs from the fast build: {mm}")
    for name in ("rerank_scan", "char_histogram"):
        require(launches[name] > 0, f"phase 5: kernel {name} never launched")
    # the seed builder's Re-rank runs once per doubling round
    out = {"n": len(dna_toks), "build_s": build_s,
           "rounds": launches["rerank_scan"], "peak_mem_gib": peak_gib,
           "launches": launches, "fast_build_s": kept["build_s"],
           "identical_to_fast": True,
           "profile_build": profiled(lambda: build_index(
               dna_toks, sample_rate=64, sa_sample_rate=32, fast=False,
               device="cuda"), watch=BUILD_WATCH)}
    del seed
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 6: save -> restore, and the launcher's --ckpt-dir / --restore
# --------------------------------------------------------------------------

def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_restore(kept, proteins_log2n: int,
                  keep_ckpt: Path | None = None) -> tuple[dict, dict]:
    """Returns (the phase's record, launches per restore path).  With
    ``keep_ckpt`` the stored-layout checkpoint is written there and left
    for phase 10."""
    import torch

    from repro_torch.configs.bwt_index import CONFIG as icfg
    from repro_torch.core.fm_index import fm_mismatch
    from repro_torch.core.index_io import (
        _FM_LAYOUT,
        restore_index,
        save_index,
    )
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving.engine import FMQueryServer
    from repro_torch.training.checkpoint import Checkpointer

    index = kept["index"]
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=build_dir))
    out, launches = {}, {}
    try:
        stored, derived = keep_ckpt or tmp / "stored", tmp / "derived"
        t0 = time.perf_counter()
        save_index(str(stored), index)
        out["save_s"] = time.perf_counter() - t0
        out["bytes_on_disk"] = dir_bytes(stored)

        # the reference's sharded kind stores no single-device layout
        t0 = time.perf_counter()
        flat, meta = Checkpointer(str(stored)).restore_raw()
        out["read_npz_s"] = time.perf_counter() - t0   # host side of restore
        for name in _FM_LAYOUT:
            flat.pop(name, None)
        meta.pop("step")
        meta.update(kind="dist_fm", arrays=sorted(flat))
        Checkpointer(str(derived)).save(0, flat, extra=meta)
        del flat
        out["derived_bytes_on_disk"] = dir_bytes(derived)

        for name, path in (("stored_layout", stored),
                           ("derived_layout", derived)):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            rest = restore_index(str(path), device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches[name] = dict(_build.LAUNCHES)
            mm = fm_mismatch(index.fm, rest.fm)
            require(mm == [], f"{name} restore differs: {mm}")
            server = FMQueryServer.from_config(
                rest, icfg.replace(locate_k=LOCATE_K), device="cuda")
            counts = [int(x) for x in server.count(kept["pats"])]
            located = server.locate(kept["pats"])
            require(counts == kept["counts"], f"{name}: counts differ")
            require(len(located) == len(kept["located"]) and all(
                torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                for a, b in zip(located, kept["located"])),
                f"{name}: locates differ")
            out[name] = {"restore_s": secs, "fm_mismatch": mm,
                         "answers": "1024 count + 1024 locate identical",
                         "launches": launches[name]}
            del rest, server
        require(launches["derived_layout"]["char_histogram"] > 0,
                "phase 6: char_histogram never launched on the derived "
                "restore")

        # the launcher: build + save, then restore + serve
        ck = tmp / "launcher"
        argv = ["--kind", "proteins", "--n", str(1 << proteins_log2n),
                "--ckpt-dir", str(ck), "--device", "cuda"]
        results = {}
        for mode, extra in (("build", []), ("restore", ["--restore"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                results[mode] = serve.main(argv + extra)
            text = buf.getvalue()
            want = "checkpointed to" if mode == "build" else "restored fm"
            require(want in text, f"launcher {mode}: no '{want}' line")
            out[f"launcher_{mode}"] = text.strip().splitlines()
        require(results["build"] == results["restore"],
                f"launcher answers differ: {results}")
        require(results["restore"]["total_hits"] > 0, "launcher: no hits")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches


# --------------------------------------------------------------------------
# phase 7: the rebuild-free BWT merge (k-way walk and pairwise fold)
# --------------------------------------------------------------------------

MERGE_R, MERGE_SRATE = 64, 32
# document sizes of a compaction run, as 2^(largest - d) tokens: the largest
# first (never walked), compact_max_small = 8 segments for DNA
DNA_RUN = (0, 1, 1, 2, 2, 3, 3, 3)
PROTEIN_RUN = (0, 1, 1, 2)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device):
    """(fn(), wall seconds), each end synchronized on a CUDA device."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def start_script_build(src: Path, entries: dict):
    """Start ``nvcc`` on ``src``, one of this script's own CUDA sources
    under scripts/ (a measurement, not a kernel of the port), beside the
    kernels' build; returns a function that waits for it and gives its C
    entries, ``entries`` mapping each name to its ctypes argument types."""
    import ctypes

    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"{src.stem}.so"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"{src.name} build failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        fns = {}
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = [getattr(ctypes, t) for t in argtypes]
            fn.restype = ctypes.c_int
            fns[name] = fn
        fns["ptxas"] = [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]
        return fns

    return finish


def start_chase_build():
    """``start_script_build`` of the pointer chase; its finish gives the C
    entry."""
    finish = start_script_build(CHASE_SRC,
                                {"pointer_chase_launch": CHASE_ARGTYPES})
    return lambda: finish()["pointer_chase_launch"]


def dependent_load_ns(chase, n: int, steps: int = 1 << 16,
                      seed: int = 0) -> float:
    """Nanoseconds of one dependent global load on the card: the one-thread
    pointer chase ``chase`` (``start_chase_build``) through a random
    single-cycle permutation of ``n`` int32 words, timed with CUDA events
    at ``steps`` and ``2 * steps`` loads so the launch cost cancels."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(n, generator=g, device="cuda")
    nxt = torch.empty(n, dtype=torch.int32, device="cuda")
    nxt[order] = torch.roll(order, -1).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def run(s):
        err = chase(nxt.data_ptr(), s, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"pointer chase launch failed: CUDA error {err}")

    run(steps)                                       # warm-up
    ms = []
    for s in (steps, 2 * steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(s)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return (ms[1] - ms[0]) * 1e6 / steps


@contextlib.contextmanager
def observed_merge(device):
    """Run the merge entry points as they are while recording what they
    call in ``core/bwt_merge``: the precompute of each walk
    (``_pairwise_walk_inputs`` / ``_kway_walk_inputs`` and
    ``_walk_seeds``; an outermost call timed between two synchronizes, the
    calls before a walk summed) and each walk (``merge_walk`` /
    ``kway_walk``, one kernel launch on the card) timed the same way and,
    on the card, by CUDA events around it, with its name, arguments and
    ``ins`` kept, and the arguments of each batched rank call of the
    precompute (``ops.rank_walkers``: the walked rows' LF map).  Yields
    {"pre_s": [seconds], "walks": [{"name", "args", "kw", "ins", "s",
    "device_ms"}], "ranks": [{"args", "kw"}]} in call order; the modules'
    functions are restored on exit."""
    import torch

    from repro_torch.core import bwt_merge as bm

    cuda = torch.device(device).type == "cuda"
    seen = {"pre_s": [], "walks": [], "ranks": []}
    pending, depth = [0.0], [0]

    def precompute(fn):
        def run(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            try:
                out, s = timed(lambda: fn(*args, **kw), device)
            finally:
                depth[0] -= 1
            pending[0] += s
            return out
        return run

    def walk(fn, name):
        def run(*args, **kw):
            events = None
            if cuda:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
            _sync(device)
            t0 = time.perf_counter()
            if events:
                events[0].record()
            ins = fn(*args, **kw)
            if events:
                events[1].record()
            _sync(device)
            seen["walks"].append(dict(
                name=name, args=args, kw=kw, ins=ins,
                s=time.perf_counter() - t0,
                device_ms=events[0].elapsed_time(events[1]) if events
                else None))
            seen["pre_s"].append(pending[0])
            pending[0] = 0.0
            return ins
        return run

    def rank(fn):
        def run(*args, **kw):
            seen["ranks"].append(dict(args=args, kw=kw))
            return fn(*args, **kw)
        return run

    wraps = {"_pairwise_walk_inputs": precompute,
             "_kway_walk_inputs": precompute, "_walk_seeds": precompute,
             "merge_walk": lambda fn: walk(fn, "merge_walk"),
             "kway_walk": lambda fn: walk(fn, "kway_walk")}
    saved = {name: getattr(bm, name) for name in wraps}
    rank_walkers = bm.ops.rank_walkers
    for name, wrap in wraps.items():
        setattr(bm, name, wrap(saved[name]))
    bm.ops.rank_walkers = rank(rank_walkers)
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(bm, name, fn)
        bm.ops.rank_walkers = rank_walkers


def lf_map_call(call: dict) -> tuple:
    """(kernel name, its arguments, keywords) of an observed LF-map rank
    call (``ops.rank_walkers``: fused, blocks, occ, blk, c, cut; bits,
    sigma): the single-batch rank kernel it launches and what it passes."""
    fused, blocks, _, blk, c, cut = call["args"]
    bits, sigma = call["kw"]["bits"], call["kw"]["sigma"]
    if bits:
        return "rank_packed", (fused, blk, c, cut), dict(bits=bits,
                                                         sigma=sigma)
    return "rank_select", (blocks, blk, c, cut), {}


def lf_map_row(call: dict, floor=None, warp=None, stamps=None) -> dict:
    """The LF-map rank batch of a walk (``lf_map_call``): its kernel, B,
    operand and query shape, and on the card ``rank_row``'s parity, times,
    bytes bound and, with ``floor``, latency floor (with ``warp``, the
    pre-redesign unpacked kernel beside it, with ``stamps`` both stamped)."""
    name, args, kw = lf_map_call(call)
    blk = args[1]
    row = dict(kernel=name, B=int(blk.numel()),
               shape=f"{'fused' if kw else 'blocks'}"
                     f"[{args[0].shape[0]},{args[0].shape[1]}], "
                     f"B={blk.numel()} consecutive rows")
    if blk.device.type == "cuda":
        row.update(rank_row(name, args, kw, row["shape"], floor,
                            plain_reps=5, warp=warp, stamps=stamps))
    return row


# the plain walks take a walk's layout arguments only: the pairwise walk's
# first 7, the k-way walk's first 8 (no clf, no seeds)
PLAIN_ARGS = {"merge_walk": 7, "kway_walk": 8}


def plain_walk(w):
    """The plain walk of an observed walk ``w``, on its arguments."""
    from repro_torch.kernels import merge_walk as mw

    plain = (mw.merge_walk_plain if w["name"] == "merge_walk"
             else mw.kway_walk_plain)
    return plain(*w["args"][:PLAIN_ARGS[w["name"]]],
                 **{k: w["kw"][k] for k in ("sigma", "bits", "r")})


def walk_form(w):
    """(``WalkForm``, seeds, walked lengths) of an observed walk, for the
    plain chained model."""
    from repro_torch.kernels import merge_walk as mw

    args, kw = w["args"], {k: w["kw"][k] for k in ("sigma", "bits", "r")}
    if w["name"] == "merge_walk":
        seeds = args[7] if len(args) > 7 else w["kw"].get("seeds")
        return (mw.pairwise_form(*args[:7], **kw), seeds,
                [args[5].shape[0]])
    return mw.kway_form(*args[:9], **kw), args[9], list(args[7][1:])


def walk_chains(w, device, want, what: str, strides=()) -> dict:
    """The chains of an observed walk ``w``: on the card its wrapper
    called again with a report (the plan, the seed table, the seeds'
    meeting steps; its ``ins`` equal to ``want``) and the plain chained
    model on the same seed table, whose ``ins`` must equal ``want`` and
    whose meeting steps the kernel's; then the wrapper at each of
    ``strides`` too, each ``ins`` equal to ``want``, and the kernel's
    device time alone (``kernel_device_ms``: the profiler over 20 calls of
    the wrapper, per recorded launch).  On the CPU (the plain walk ran:
    one chain) the model alone, at twice the SA rate.  Returns
    ``merge_walk.chain_stats`` with the stride, the source of the chains
    and the bytes the wrapper reports (``kernels/traffic.py``)."""
    import types

    import torch

    from repro_torch.kernels import merge_walk as mw
    from repro_torch.kernels import traffic

    form, seeds, lens = walk_form(w)
    steps = sum(lens) - 1
    wrapper = getattr(mw, w["name"])
    moved = {}
    sink = types.SimpleNamespace(
        kernel_bytes=lambda name, n: moved.__setitem__(name, n))
    rep = {}
    with traffic.recording(sink):
        ins = wrapper(*w["args"], **w["kw"], report=rep)
    out = {"bytes": moved["merge_walk"]}
    if torch.device(device).type == "cuda":
        same(ins, want, f"{what} (called again)")
        table, stride = rep["seeds"], rep["plan"]["stride"]
        meets = rep["meets"]
        out.update(source="kernel", registers=rep["plan"].get("registers"),
                   blocks_per_sm=rep["plan"].get("blocks_per_sm"))
        kernel = ("pairwise_kernel" if w["name"] == "merge_walk" else
                  "kway_chain_kernel" if mw.chain_lanes(len(lens) + 1)
                  else "kway_block_kernel")
        out["kernel"] = kernel
        out["kernel_device_ms"] = kernel_device_ms(
            lambda: wrapper(*w["args"], **w["kw"]), kernel)
        for extra in strides:
            if seeds is not None and extra != stride:
                same(wrapper(*w["args"], **w["kw"], stride=extra), want,
                     f"{what} at stride {extra}")
    else:
        stride = 2 * seeds.rate if seeds is not None else 0
        table = (mw.seed_table(seeds, lens, stride) if stride else
                 torch.zeros((0, 4), dtype=torch.int32))
        meets = None
        out["source"] = "plain model"
    model = mw.chained_walk(form, table)
    same(model["ins"], want, f"{what}: the chained model", ref="plain")
    if meets is not None:
        same(meets, model["meets"], f"{what}: the seeds' meeting steps",
             ref="the plain model's")
    else:
        meets = model["meets"]
    return {"stride": stride, **mw.chain_stats(table, meets, steps), **out}


def prepared_indexes(docs, sigma_decl: int, device):
    """Each document prepared as a segment append prepares it
    (``prepare_tokens(d, r, sigma_declared)``) and built on ``device``:
    (prepared texts, sigma, FM indexes, their full suffix arrays)."""
    from repro_torch.core.pipeline import build_index_prepared, prepare_tokens

    preps, sig = [], None
    for d in docs:
        s, sig = prepare_tokens(d, MERGE_R, sigma_decl)
        preps.append(s)
    built = [build_index_prepared(s, sig, sample_rate=MERGE_R,
                                  sa_sample_rate=MERGE_SRATE, device=device)
             for s in preps]
    return preps, sig, [b.fm for b in built], [b.sa for b in built]


def rebuild(preps, sig: int, device):
    """The oracle: ``build_index_prepared`` of the concatenated texts (the
    whole ``SequenceIndex``: its ``fm`` and its full ``sa``)."""
    import numpy as np

    from repro_torch.core.pipeline import build_index_prepared

    return build_index_prepared(np.concatenate(preps), sig,
                                sample_rate=MERGE_R,
                                sa_sample_rate=MERGE_SRATE, device=device)


def expected_ins(flavour: str, sas, sa_u, lens) -> list:
    """Each walk's ``ins`` as the suffix arrays imply it, walk by walk in
    the entry points' order: a walked suffix's merged row minus its own
    row.  ``sas`` are the documents' own suffix arrays, ``sa_u`` the
    rebuild's.  K-way: segment s's row i is the suffix starting at offs[s]
    + SA_s[i] of the concatenation U, whose rank in SA(U) is its merged
    row.  Fold (the walk that merges document d into the accumulator of
    documents d+1 ..): the suffixes of U starting at offs[d] or later are
    that concatenation's suffixes, the same strings, so SA(U) restricted
    to them gives both the accumulator's own rows and their merged rows."""
    import torch

    dev = sa_u.device
    sa_u = sa_u.long()
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)

    def ranks_from(start):
        """(SA of the suffixes from ``start``, shifted to 0; the rank of
        each such suffix among them, by position in U)."""
        sub = sa_u[sa_u >= start]
        rank = torch.full((offs[-1],), -1, dtype=torch.long, device=dev)
        rank[sub] = torch.arange(sub.numel(), device=dev)
        return sub - start, rank

    if flavour == "kway":
        _, rank = ranks_from(0)
        return [torch.cat([rank[offs[s] + sas[s].long()]
                           - torch.arange(lens[s], device=dev)
                           for s in range(1, len(lens))])]
    out = []
    for d in range(len(lens) - 2, -1, -1):
        own, _ = ranks_from(offs[d + 1])
        _, rank = ranks_from(offs[d])
        out.append(rank[offs[d + 1] + own]
                   - torch.arange(own.numel(), device=dev))
    return out


def stride_sweep(w, strides) -> list:
    """The kernel of an observed walk ``w`` on the card at each seed stride
    of ``strides``: its device time alone (``kernel_device_ms``) beside
    its chains (fewer, longer chains as the stride grows: how a step's
    time moves with the chains in flight)."""
    from repro_torch.kernels import merge_walk as mw

    _, _, lens = walk_form(w)
    wrapper = getattr(mw, w["name"])
    kernel = ("pairwise_kernel" if w["name"] == "merge_walk"
              else "kway_chain_kernel")
    out = []
    for stride in strides:
        rep = {}
        wrapper(*w["args"], **w["kw"], stride=stride, report=rep)
        stats = mw.chain_stats(rep["seeds"], rep["meets"], sum(lens) - 1)
        ms = kernel_device_ms(
            lambda: wrapper(*w["args"], **w["kw"], stride=stride), kernel)
        out.append({"stride": stride, "kernel_device_ms": ms,
                    "chains": stats["chains"],
                    "longest_chain": stats["longest_chain"],
                    "us_per_longest_step": ms * 1e3
                    / stats["longest_chain"]})
    return out


def merge_walk_parity(device="cuda", log2n: int = 12, ks=(2, 3, 8, 33),
                      many: int = 1100,
                      chains: dict | None = None) -> tuple[int, list, dict]:
    """``merge_walk`` against its plain walks on the same tensors, on small
    walks of about 2^log2n steps: the walk each merge entry point launched
    (``observed_merge``) held against the plain walk of its arguments,
    pairwise and k-way over ``ks``, packed (DNA, 4-bit) and unpacked
    (proteins), and each merge equal to the rebuild; each walk's chains
    (``walk_chains``: the kernel again at the plan's stride, at the SA rate
    and at twice it, the plain chained model on the plan's seeds, its
    meeting steps the kernel's).  Then a run of ``many`` one- and
    two-token segments (past 32 lanes one chain; past 1024 the block
    kernel strides its threads over the lanes) merged and held against
    the rebuild.  Returns (max error, cases, the kernel's ms (CUDA events,
    five calls) and the plain walk's (host clock, the parity call) on the
    DNA pairwise and k = 8 walks; empty off the card); ``chains``, a dict,
    receives each case's chains."""
    import torch

    from repro_torch.core import bwt_merge as bm
    from repro_torch.core.fm_index import fm_mismatch
    from repro_torch.data.corpus import corpus
    from repro_torch.kernels import merge_walk as mw

    cuda = torch.device(device).type == "cuda"
    err, cases, times = 0, [], {}
    chains = {} if chains is None else chains

    def walked(merge, preps, sig, what):
        """The one walk ``merge`` launches, held against its plain walk
        and its chains checked; the merge held against the rebuild.
        (walk, plain s)"""
        with observed_merge(device) as seen:
            merged = merge()
        require(len(seen["walks"]) == 1, f"{what}: one walk per merge")
        mm = fm_mismatch(merged, rebuild(preps, sig, device).fm)
        require(mm == [], f"{what}: merge != rebuild: {mm}")
        w = seen["walks"][0]
        want, plain_s = timed(lambda: plain_walk(w), device)
        nonlocal err
        err = max(err, same(w["ins"], want, what))
        chains[what] = walk_chains(w, device, want, what,
                                   strides=(MERGE_SRATE, 2 * MERGE_SRATE))
        return w, plain_s

    for kind, sig_decl in (("dna", 6), ("proteins", 22)):
        preps, sig, (left, right), _ = prepared_indexes(
            [corpus(kind, 1 << (log2n - 1), seed=1),
             corpus(kind, 1 << log2n, seed=2)], sig_decl, device)
        w, plain_s = walked(lambda: bm.merge_fm_indexes(left, right), preps,
                            sig, f"merge_walk pairwise {kind}")
        cases.append(f"pairwise {kind} bits={left.bits} "
                     f"steps={right.length - 1}")
        if cuda and kind == "dna":
            times["pairwise"] = dict(
                steps=right.length - 1,
                ms=time_ms(lambda: mw.merge_walk(*w["args"], **w["kw"]), 5),
                plain_ms=plain_s * 1e3)
        for k in ks:
            docs = [corpus(kind, 1 << (log2n - 1), seed=10)] + [
                corpus(kind, max(64, (1 << log2n) // (k - 1)), seed=11 + i)
                for i in range(k - 1)]
            preps, sig, fms, _ = prepared_indexes(docs, sig_decl, device)
            w, plain_s = walked(lambda: bm.merge_kway(fms), preps, sig,
                                f"merge_walk k-way {kind} k={k}")
            steps = bm.kway_walk_steps(f.length for f in fms)
            cases.append(f"k-way {kind} k={k} steps={steps}")
            if cuda and kind == "dna" and k == 8:
                times["kway"] = dict(
                    k=k, steps=steps,
                    ms=time_ms(lambda: mw.kway_walk(*w["args"], **w["kw"]),
                               5),
                    plain_ms=plain_s * 1e3)
    # four distinct tiny documents, cycled: the built indexes are reused
    tiny = [[1], [2], [3], [1, 2]]
    preps, sig, fms, _ = prepared_indexes(tiny, 6, device)
    run = [i % 4 for i in range(many)]
    mm = fm_mismatch(bm.merge_kway([fms[i] for i in run]),
                     rebuild([preps[i] for i in run], sig, device).fm)
    require(mm == [], f"k-way over {many} segments != rebuild: {mm}")
    cases.append(f"k-way dna-like k={many} vs rebuild")
    return err, cases, times


def merge_run(kind: str, sig_decl: int, log2n: int, shape, flavour: str,
              device="cuda", latency_ns=None, sweep=(), floor=None,
              warp=None, stamps=None) -> tuple[dict, dict]:
    """One merge path at real scale: documents of 2^(log2n - d) tokens for
    d in ``shape``, merged k-way or by the pairwise fold (the accumulator
    starts from the last document, each earlier one merges in on its
    left) through the entry points, once, launches counted around the
    merge alone and its stages observed (``observed_merge``: precompute
    and walk times; splice + ``build_fm_index`` is the rest of the
    merge's time).  Then the rebuild of the concatenation and the checks:
    each walk's ``ins`` equal to the one the suffix arrays imply
    (``expected_ins``), the merge equal to the rebuild in every field,
    1024 count and 1024 locate (k = 16) answers equal, one walk launch and
    one rank launch (the walked rows' LF map) per walk.  Each walk's chains
    (``walk_chains``: on the card the kernel's seeds and their meeting
    steps, equal to the plain chained model's) and its bytes bound (the
    bytes its wrapper reports over the HBM peak): a walk's device time
    under it fails.  With ``latency_ns(n)`` (ns of one dependent load over
    n words) each walk gets its latency floor, ``bound_s``: its longest
    chain's steps, seed included, x latency (one dependent row fetch a
    step, either flavour), and a walk under it fails.  On the card the
    last walk is also timed at each seed stride of ``sweep``
    (``stride_sweep``).  The last walk's LF-map rank batch is
    ``lf_map_row``'s (on the card timed, with ``floor`` beside its latency
    floor, ``warp`` beside the pre-redesign kernel and ``stamps``).
    Returns (record, launches)."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import bwt_merge as bm
    from repro_torch.core.fm_index import count, fm_mismatch, locate
    from repro_torch.data.corpus import corpus
    from repro_torch.kernels import _build

    docs = [corpus(kind, 1 << (log2n - d), seed=100 + i)
            for i, d in enumerate(shape)]
    preps, sig, fms, sas = prepared_indexes(docs, sig_decl, device)
    lens = [f.length for f in fms]
    bits = fms[0].bits

    def fold():
        acc = fms[-1]
        for left in reversed(fms[:-1]):
            acc = bm.merge_fm_indexes(left, acc)
        return acc

    merge = (lambda: bm.merge_kway(fms)) if flavour == "kway" else fold
    with observed_merge(device) as seen:
        _build.reset_launches()
        merged, merge_s = timed(merge, device)
        launches = dict(_build.LAUNCHES)

    cuda = torch.device(device).type == "cuda"
    n_walks = 1 if flavour == "kway" else len(fms) - 1
    rank = "rank_packed" if bits else "rank_select"
    want = {"merge_walk": n_walks, "char_histogram": n_walks, rank: n_walks,
            ("rank_select" if bits else "rank_packed"): 0}
    for name, n in want.items():
        got = launches[name]
        require(got == (n if cuda else 0),
                f"{kind} {flavour}: {got} {name} launches, want {n}")
    walks = seen["walks"]
    require(len(walks) == n_walks == len(seen["pre_s"])
            == len(seen["ranks"]),
            f"{kind} {flavour}: {len(walks)} walks and "
            f"{len(seen['ranks'])} LF maps observed, want {n_walks}")

    built, rebuild_s = timed(lambda: rebuild(preps, sig, device), device)
    err, chains = 0, []
    for i, (w, ins) in enumerate(zip(walks, expected_ins(flavour, sas,
                                                         built.sa, lens))):
        err = max(err, same(w["ins"], ins, f"{kind} {flavour} walk {i}",
                            ref="the rebuild's suffix arrays"))
        chains.append(walk_chains(w, device, ins, f"{kind} {flavour} walk "
                                                  f"{i}"))
    mm = fm_mismatch(merged, built.fm)
    require(mm == [], f"{kind} {flavour}: merge != rebuild: {mm}")
    pats = sample_patterns(np.concatenate(docs), 1024, seed=70)
    P = pad_patterns(pats, 32, device)
    require(torch.equal(count(merged, P), count(built.fm, P)),
            f"{kind} {flavour}: counts differ from the rebuild")
    for a, b in zip(locate(merged, P, LOCATE_K),
                    locate(built.fm, P, LOCATE_K)):
        require(torch.equal(a, b),
                f"{kind} {flavour}: locates differ from the rebuild")

    if flavour == "kway":
        shapes = [(lens[0], bm.kway_walk_steps(lens), sum(lens))]
    else:   # walk j merges document k-2-j into the accumulator after it
        shapes = [(lens[d], sum(lens[d + 1:]) - 1, sum(lens[d:]))
                  for d in range(len(lens) - 2, -1, -1)]
    stages = []
    for (left_n, steps, merged_n), w, pre_s, ch in zip(
            shapes, walks, seen["pre_s"], chains):
        st = dict(left_n=left_n, steps=steps, merged_n=merged_n,
                  precompute_s=pre_s, walk_s=w["s"],
                  walk_device_ms=w["device_ms"],
                  us_per_step=w["s"] * 1e6 / max(steps, 1), chains=ch,
                  bytes_bound_ms=bound_ms(ch["bytes"]))
        if cuda:
            for t in (w["device_ms"], ch["kernel_device_ms"]):
                require(t >= st["bytes_bound_ms"],
                        f"{kind} {flavour}: walk {t} ms is under its bytes "
                        f"bound {st['bytes_bound_ms']} ms")
        if latency_ns is not None:
            lat = latency_ns(left_n)
            st["latency_ns"] = lat
            st["bound_s"] = ch["longest_chain"] * lat / 1e9
            for t in (st["walk_s"] * 1e3, st["walk_device_ms"],
                      ch.get("kernel_device_ms")):
                if t is not None:
                    require(t >= st["bound_s"] * 1e3,
                            f"{kind} {flavour}: walk {t} ms is under its "
                            f"latency bound {st['bound_s'] * 1e3} ms")
        stages.append(st)
    N = sum(lens)
    total = {k: sum(st[k] for st in stages)
             for k in ("steps", "precompute_s", "walk_s")}
    splice_s = merge_s - total["precompute_s"] - total["walk_s"]
    rec = {"kind": kind, "flavour": flavour, "k": len(fms), "sigma": sig,
           "bits": bits, "doc_tokens": [len(d) for d in docs],
           "prepared": lens, "merged_n": N, "merge_s": merge_s,
           "rebuild_s": rebuild_s, "merge_over_rebuild": merge_s / rebuild_s,
           "stages": stages, **total, "splice_build_s": splice_s,
           "walk_us_per_step": total["walk_s"] * 1e6 / total["steps"],
           "splice_ns_per_token": splice_s * 1e9
           / sum(st["merged_n"] for st in stages),
           "sort_ns_per_token_log2n": rebuild_s * 1e9 / (N * math.log2(N)),
           "launches": launches, "fm_mismatch": [], "ins_max_abs_err": err,
           "answers": "1024 count + 1024 locate identical to the rebuild"}
    rec["bytes_bound_ms"] = sum(st["bytes_bound_ms"] for st in stages)
    rec["lf_map"] = lf_map_row(seen["ranks"][-1], floor, warp, stamps)
    if cuda and sweep:
        stages[-1]["stride_sweep"] = stride_sweep(walks[-1], sweep)
    if cuda:
        rec["walk_device_ms"] = sum(st["walk_device_ms"] for st in stages)
        rec["kernel_device_ms"] = sum(st["chains"]["kernel_device_ms"]
                                      for st in stages)
    if latency_ns is not None:
        rec["bound_s"] = sum(st["bound_s"] for st in stages)
    return rec, launches


def phase_merge(log2n: int, chase, warp=None, stamps=None):
    """Phase 7: the walk kernel against its plain versions, then merges
    (a) DNA k-way, (b) DNA pairwise fold of the same eight documents, (c)
    proteins k-way, with ``chase`` (``start_chase_build``) for the latency
    floors.  Returns (record, launches per path, the merge_walk row of the
    kernels line)."""
    import functools

    small_chains = {}
    err, cases, small = merge_walk_parity(chains=small_chains)
    latency_ns = functools.lru_cache(maxsize=None)(
        functools.partial(dependent_load_ns, chase))
    floor = rank_floor(chase)

    runs, launches = {}, {}
    sweep = (32, 64, 128, 256, 512, 1024)
    for name, args in (("dna_kway", ("dna", 6, log2n, DNA_RUN, "kway")),
                       ("dna_fold", ("dna", 6, log2n, DNA_RUN, "pairwise")),
                       ("proteins_kway", ("proteins", 22, log2n - 1,
                                          PROTEIN_RUN, "kway"))):
        runs[name], launches[f"merge_{name}"] = merge_run(
            *args, latency_ns=latency_ns,
            sweep=sweep if name.startswith("dna") else (), floor=floor,
            warp=warp, stamps=stamps)
    a, b, c = runs["dna_kway"], runs["dna_fold"], runs["proteins_kway"]
    costs = {"pairwise_step_ns": b["walk_s"] * 1e9 / b["steps"],
             "kway_step_ns": a["walk_s"] * 1e9 / a["steps"],
             "kway_step_ns_proteins": c["walk_s"] * 1e9 / c["steps"],
             "token_ns": a["splice_ns_per_token"],
             "token_ns_fold": b["splice_ns_per_token"],
             "sort_ns_per_token_log2n": a["sort_ns_per_token_log2n"]}
    # walk (a) on the merge path: its time (synchronized host clock; CUDA
    # events around the wrapper call), the kernel's device time alone
    # (profiler) beside its bytes bound and latency floor, its ins against
    # the suffix arrays' (every walk of (a)-(c)) and against the plain
    # walks (the small walks)
    (st,) = a["stages"]
    row = dict(max_abs_err=max(err, *(r["ins_max_abs_err"]
                                      for r in runs.values())),
               ms=a["walk_s"] * 1e3, events_ms=a["walk_device_ms"],
               device_ms=st["chains"]["kernel_device_ms"],
               plain_ms=small["kway"]["plain_ms"],
               bound_ms=st["bytes_bound_ms"], bound_by="bytes",
               latency_floor_ms=st["bound_s"] * 1e3, library_ms=None,
               chains={k: st["chains"].get(k) for k in (
                   "stride", "chains", "seeds_met", "seeds_tried",
                   "median_steps_to_meet", "max_steps_to_meet",
                   "longest_chain", "registers", "blocks_per_sm")},
               shape=f"DNA k-way walk, k=8, {a['steps']} steps",
               plain_shape=f"DNA k-way walk, k=8, "
               f"{small['kway']['steps']} steps")
    rec = {"walk_parity": {"max_abs_err": err, "cases": cases,
                           "chains": small_chains},
           "small_walks": small, "runs": runs, "cost_constants": costs}
    return rec, launches, row


# --------------------------------------------------------------------------
# phase 8: the segmented catalog (stacked queries, compaction, save/load)
# --------------------------------------------------------------------------

DNA_SEGMENTS = 16        # the launcher's --segments split of the corpus
PROTEIN_SEGMENTS = 4


def bucket_bytes(n_seg: int, max_blocks: int, row_words: int, r: int,
                 srate: int) -> dict:
    """The stacked bucket of ``n_seg`` segments whose largest has
    ``max_blocks`` blocks: ``seg_pad`` and ``blocks_pad`` (powers of two),
    the bytes of its rows (``row_words`` int32 per block: sigma + packed
    words, or r + sigma for blocks plus checkpoints) and of its SA sample
    (marks, their ranks and raw values per segment)."""
    S = 1 << (n_seg - 1).bit_length()
    NB = 1 << (max_blocks - 1).bit_length()
    MW, MV = -(-(NB * r) // 32), -(-(NB * r) // srate)
    return {"seg_pad": S, "blocks_pad": NB, "rows": 4 * S * NB * row_words,
            "sa_sample": 4 * S * (2 * MW + MV)}


def stacked_bucket_bytes(st) -> dict:
    """``bucket_bytes``' fields of a built bucket, from its tensors."""
    rows = sum(t.numel() for t in (st.fused, st.blocks, st.occ)
               if t is not None)
    sample = sum(t.numel() for t in (st.sa_marks, st.sa_mark_ranks,
                                     st.sa_vals) if t is not None)
    return {"seg_pad": st.seg_pad, "blocks_pad": st.blocks_pad,
            "rows": 4 * rows, "sa_sample": 4 * sample}


def segment_view(st, s: int):
    """``kernels/traffic.py`` ``segment_view`` (the reckoning the kernel
    wrappers report to ``launch/roofline.py`` ``count``)."""
    from repro_torch.kernels.traffic import segment_view

    return segment_view(st, s)


def stacked_query_bytes(st, P, k: int) -> tuple[int, int]:
    """``kernels/traffic.py`` ``stacked_query_bytes`` (the reckoning the kernel
    wrappers report to ``launch/roofline.py`` ``count``)."""
    from repro_torch.kernels.traffic import stacked_query_bytes

    return stacked_query_bytes(st, P, k)


def stacked_fns(st):
    """(kernel name, wrapper, plain version) of the bucket's layout."""
    from repro_torch.kernels import fm_query as fq

    if st.bits:
        return ("fm_query_stacked_packed", fq.fm_query_stacked_packed,
                fq.fm_query_stacked_packed_plain)
    return ("fm_query_stacked_unpacked", fq.fm_query_stacked_unpacked,
            fq.fm_query_stacked_unpacked_plain)


def check_stacked(st, cases, what: str, lanes=None) -> int:
    """Every case through the bucket's stacked kernel (and the
    pre-redesign one, given ``lanes``) and its plain version on the same
    tensors: sp, ep and the positions equal; the max abs error (0)."""
    name, kern, plain = stacked_fns(st)
    err = 0
    for case, P, k in cases:
        want = plain(st, P, k)
        runs = [(name, kern(st, P, k))]
        if lanes is not None:
            runs.append((f"pre-redesign {name}", lanes_query(lanes, st, P,
                                                             k)))
        for who, got in runs:
            tag = f"{who} {what} {case} k={k}"
            err = max(err, same(got[0], want[0], f"{tag} sp"),
                      same(got[1], want[1], f"{tag} ep"),
                      same(got[2], want[2], f"{tag} positions"))
    return err


def stacked_timing(st, P, k: int) -> dict:
    """The stacked kernel on one batch: event and device ms beside its
    bytes bound and dependent steps, and the plain version's ms."""
    name, kern, plain = stacked_fns(st)
    nbytes, walk = stacked_query_bytes(st, P, k)
    return dict(
        m=P.shape[1], B=P.shape[0], k=k, n_seg=st.n_seg, seg_pad=st.seg_pad,
        ms=time_ms(lambda: kern(st, P, k), 20),
        device_ms=kernel_device_ms(lambda: kern(st, P, k), f"{name}_kernel"),
        plain_ms=time_ms(lambda: plain(st, P, k), 1),
        bound_ms=bound_ms(nbytes), bytes=nbytes,
        dependent_steps={"search": P.shape[1], "walk": walk})


SWEEP_SEGMENTS = (1, 2, 4, 8, 16)   # the n_seg views of the segment sweep
SMALL_BATCH = 64                    # near the frontend's coalesced batches
EDGE_KS = (0, 1, LOCATE_K, 64)


def lanes_query(lanes, st, P, k: int):
    """The stacked kernel before its redesign (``LANES_SRC``, built by
    ``start_script_build``) on the bucket, with the port wrapper's C
    arguments: one launch, ``(sp, ep, positions)``."""
    import torch

    from repro_torch.kernels import fm_query as fq

    name = stacked_fns(st)[0]
    out, args = fq.stacked_launch_args(name, st, P, k)
    entry = ("stacked_lanes_packed_launch" if st.bits
             else "stacked_lanes_unpacked_launch")
    if P.shape[0]:
        err = lanes[entry](*args, *(t.data_ptr() for t in out),
                           torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"{entry} failed: CUDA error {err}")
    return out


def lanes_blocks(st, B: int, k: int) -> int:
    """Blocks of the pre-redesign launch: 128-thread blocks over B x
    max(k, 1) lanes (packed) or B x 16 * ceil(k / 16) lanes, at least 16
    (unpacked), times seg_pad."""
    lanes = max(k, 1) if st.bits else 16 * max(-(-k // 16), 1)
    return -(-(B * lanes) // 128) * st.seg_pad


def occupancy(query, st) -> dict:
    """Registers, spilled bytes and resident blocks per SM of the
    bucket's kernel, from an occupancy entry (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    out = (ctypes.c_int * 4)()
    err = query(0 if st.bits else 1, st.bits or 4, st.sigma, out)
    require(err == 0, f"occupancy query failed: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "registers", "threads", "local_bytes"),
                    list(out)))


def waves(blocks: int, blocks_per_sm: int, sms: int) -> float:
    """Resident waves a grid of ``blocks`` takes: blocks over the card's
    resident capacity (blocks per SM x SMs)."""
    return blocks / (blocks_per_sm * sms)


def rank_words(st) -> int:
    """The int32 words a query launch's ranks read over: the fused rows,
    or the blocks and their checkpoints, of a stacked bucket or of one
    index (``FMIndex``)."""
    from repro_torch.core.fm_index import FMIndex

    if st.bits:
        return st.fused.numel()
    if isinstance(st, FMIndex):
        return st.bwt.numel() + st.occ_samples.numel()
    return st.blocks.numel() + st.occ.numel()


def latency_floor(st, P, walk: int, latency_ns) -> dict:
    """The chain of dependent loads one query launch (stacked, or fused
    over one index) cannot beat: the longest pattern's search steps (one
    round trip each: a PAD step loads nothing), then ``walk`` walk steps
    (one round trip a step on the packed layout; two on the unpacked,
    whose checkpoint waits for the symbol) and the sampled value, each one
    dependent load of ``latency_ns(words)`` ns over the operand's words
    (``rank_words``)."""
    from repro_torch.core.fm_index import PAD

    search = int((P != PAD).sum(1).max()) if P.numel() else 0
    loads = search + (walk * (1 if st.bits else 2) + 1 if walk else 0)
    words = rank_words(st)
    ns = latency_ns(words)
    return {"dependent_loads": loads, "latency_ns": ns,
            "latency_floor_ms": loads * ns / 1e6}


def stacked_edge_cases(st, seg_tokens, seed: int = 5) -> list:
    """(what, patterns, k) aimed at the walk list: the edge patterns
    (all-PAD, every length-1 pattern: more than k hits in every segment,
    symbols at and past sigma, the sentinel, absent ones) and a 40-symbol
    cut from inside the second segment (hits there alone), at k = 0, 1,
    16, 64."""
    import numpy as np

    toks = np.concatenate(seg_tokens)
    one = seg_tokens[min(1, len(seg_tokens) - 1)]
    mid = len(one) // 2
    pats = edge_patterns(toks, st.sigma, seed) + [one[mid: mid + 40]]
    E = pad_patterns(pats, 128, st.device)
    return [("edge", E, k) for k in EDGE_KS]


def check_views(st, P, k: int, lanes=None, segs=SWEEP_SEGMENTS) -> list:
    """The bucket cut to n_seg = s for each s of ``segs`` up to its own
    (``dataclasses.replace``: the rows past s become pad segments): rows
    [:s] of the kernel (and of the pre-redesign one, given ``lanes``)
    equal to the plain version's.  Returns the views checked."""
    import dataclasses

    name, kern, plain = stacked_fns(st)
    done = []
    for s in segs:
        if s > st.n_seg:
            break
        v = dataclasses.replace(st, n_seg=s)
        want = plain(v, P, k)
        runs = [("kernel", kern(v, P, k))]
        if lanes is not None:
            runs.append(("pre-redesign", lanes_query(lanes, v, P, k)))
        for what, got in runs:
            for i, field in enumerate(("sp", "ep", "positions")):
                same(got[i][:s], want[i][:s],
                     f"{name} {what} n_seg={s} {field}")
        done.append(s)
    return done


_L2_FLUSH = []     # the buffer ``cold_ms`` passes over, made at first use


def cold_ms(fn, reps: int = 20) -> float:
    """Median device ms of ``fn`` over ``reps`` calls after one warm-up,
    each call L2-cold: a pass over 256 MB of random words (read and
    written: five times the card's 50 MB L2, and not compressible as zeros
    are) runs before it, as a served batch of new patterns finds the
    bucket's rows out of L2 (a catalog's rows are ten times the L2).  CUDA
    events bracket the call alone; the pass gives the host time to queue
    it, so the events hold device time.  The median drops a stray
    reading."""
    import statistics

    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(1 << 26, dtype=torch.int32,
                                     device="cuda").random_())
    buf = _L2_FLUSH[0]
    fn()
    marks = []
    for _ in range(reps):
        buf.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def in_turns(fns: dict, turns=("old", "new", "new", "old")) -> dict:
    """L2-cold device ms (``cold_ms``) of each named function of ``fns``
    timed in ``turns``: every reading, per name in turn order."""
    out = {name: [] for name in fns}
    for name in turns:
        out[name].append(cold_ms(fns[name]))
    return out


def stacked_sweep(st, P, k: int, lanes, latency_ns,
                  segs=SWEEP_SEGMENTS) -> list:
    """The port's stacked kernel ("new") and the pre-redesign one ("old")
    on views of the bucket at n_seg = s for each s of ``segs``: L2-cold
    device ms of each in turns (old, new, new, old) beside the view's
    bytes bound and latency floor."""
    import dataclasses

    kern = stacked_fns(st)[1]
    rows = []
    for s in segs:
        if s > st.n_seg:
            break
        v = dataclasses.replace(st, n_seg=s)
        t = in_turns({"old": lambda: lanes_query(lanes, v, P, k),
                      "new": lambda: kern(v, P, k)})
        nbytes, walk = stacked_query_bytes(v, P, k)
        rows.append(dict(n_seg=s, old_ms=t["old"], new_ms=t["new"],
                         bound_ms=bound_ms(nbytes),
                         **latency_floor(v, P, walk, latency_ns)))
    return rows


def catalog_answers(cat, buckets) -> list:
    """(counts, positions, clipped counts) of every bucket of patterns
    through the catalog's count and locate (k = LOCATE_K)."""
    return [(cat.count(P), *cat.locate(P, LOCATE_K)) for P in buckets]


def same_answers(a, b, what: str, in_k: bool = False) -> None:
    """Two catalogs' answers equal: counts, clipped counts and positions
    (with ``in_k``, positions only of patterns with at most k
    occurrences: which k of more are reported follows SA order)."""
    import torch

    for i, ((c0, p0, k0), (c1, p1, k1)) in enumerate(zip(a, b)):
        require(torch.equal(c0, c1), f"{what}: counts differ (bucket {i})")
        require(torch.equal(k0, k1),
                f"{what}: locate counts differ (bucket {i})")
        keep = c0 <= LOCATE_K if in_k else torch.ones_like(c0, dtype=bool)
        require(torch.equal(p0[keep], p1[keep]),
                f"{what}: located positions differ (bucket {i})")


def check_catalog_answers(cat, pats, counts, located, n_brute: int) -> None:
    """Counts of the first ``n_brute`` requests by brute force inside each
    segment's own tokens (matches never span segments), and every located
    (global) position of every request holding its pattern."""
    import numpy as np
    import torch

    dev = cat.device
    seg_toks = [torch.as_tensor(s.tokens, device=dev) for s in cat.segments]
    for i in range(n_brute):
        p = torch.as_tensor(pats[i], device=dev)
        L, hits = p.shape[0], 0
        for t in seg_toks:
            if t.shape[0] < L:
                continue
            hit = torch.ones(t.shape[0] - L + 1, dtype=torch.bool,
                             device=dev)
            for j in range(L):
                hit &= t[j: j + t.shape[0] - L + 1] == p[j]
            hits += int(hit.sum())
        require(hits == counts[i], f"catalog count of request {i}: "
                                   f"{counts[i]} != brute force {hits}")
    toks = torch.as_tensor(np.concatenate([s.tokens for s in cat.segments]),
                           device=dev)
    check_answers(toks, pats, counts, located, n_brute=0)


def catalog_config(n: int, merge_log2n: int):
    """(cfg, full, top, docs) of the DNA corpus of ``n`` tokens as a
    catalog of ``DNA_SEGMENTS`` segments: the card's config with
    ``segment_min_tokens`` cut to a segment's size when the corpus is (a
    reduced run; ``full`` says it is not), and phase 7's eight documents,
    the largest 2^top tokens, kept under it."""
    from repro_torch.configs.bwt_index import CONFIG
    from repro_torch.data.corpus import corpus

    min_tokens = min(CONFIG.segment_min_tokens, n // DNA_SEGMENTS)
    cfg = CONFIG.replace(segment_min_tokens=min_tokens)
    top = min(merge_log2n, (min_tokens - 1).bit_length() - 1)
    docs = [corpus("dna", 1 << (top - d), seed=100 + i)
            for i, d in enumerate(DNA_RUN)]
    return cfg, min_tokens == CONFIG.segment_min_tokens, top, docs


def catalog_path(kind: str, toks, n_seg: int, cfg, device="cuda",
                 requests: int = 1024, seed: int = 8, lanes=None,
                 latency_ns=None) -> dict:
    """One catalog main path: ``SegmentedIndex.from_config`` with
    ``n_seg`` appends of ``np.array_split(toks, n_seg)`` (the launcher's
    --segments), then ``requests`` count and ``requests`` locate requests
    through ``FMQueryServer``, launches counted around it all.  Checks:
    one stacked launch per served batch and no single-index query or rank
    launch; counts by brute force inside the segments and every located
    position; every bucket's answers equal to the sequential path's
    (``parallel=False``: one single-index query per segment); the stacked
    kernel equal to its plain version on the served buckets, on
    ``stacked_edge_cases`` and on the n_seg views of the bucket
    (``check_views``).  On the card, with ``lanes`` (the pre-redesign
    kernel) and ``latency_ns`` (the pointer chase): both kernels held to
    the plain version the same way, then ``stacked_measure``.  Returns the
    record, with ``catalog``, ``pats``, ``launches`` and the kernel's
    ``row`` (its timing on the card) beside it."""
    import numpy as np
    import torch

    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import FMQueryServer

    cuda = torch.device(device).type == "cuda"
    _build.reset_launches()
    cat = SegmentedIndex.from_config(int(toks.max()) + 1, cfg,
                                     device=device)
    append_s = []
    for chunk in np.array_split(toks, n_seg):
        append_s.append(timed(lambda: cat.append(chunk), device)[1])
    build_launches = dict(_build.LAUNCHES)

    server = FMQueryServer.from_config(cat, cfg.replace(locate_k=LOCATE_K),
                                       device=device)
    pats = sample_patterns(toks, requests, seed=seed)
    _, stack_s = timed(lambda: server.count(pats[:8]), device)  # stacks
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
    serve = {k: launches[k] - build_launches[k] for k in launches}
    st = cat._stacked()
    require(st is not None and st.n_seg == n_seg,
            f"{kind} catalog: not served through a stacked bucket")
    name = stacked_fns(st)[0]
    batches = server.stats.batches
    require(serve[name] == (batches if cuda else 0),
            f"{kind} catalog: {serve[name]} {name} launches for {batches} "
            f"batches")
    others = {k: v for k, v in serve.items() if k != name and v}
    require(not others, f"{kind} catalog: other kernels launched while "
                        f"serving: {others}")
    want_bytes = bucket_bytes(
        n_seg, max(s.index.fm.n_blocks for s in cat.segments),
        st.sample_rate + st.sigma if not st.bits else st.fused.shape[1],
        st.sample_rate, st.sa_sample_rate)
    require(stacked_bucket_bytes(st) == want_bytes,
            f"{kind} catalog: bucket {stacked_bucket_bytes(st)} != "
            f"{want_bytes}")

    extra = {}
    if cuda:
        extra = {"profile_count": profiled(lambda: server.count(pats)),
                 "profile_locate": profiled(lambda: server.locate(pats))}
    check_catalog_answers(cat, pats, counts, located, n_brute=16)
    buckets = flush_buckets(pats, device)
    stacked = catalog_answers(cat, buckets)
    cat.parallel = False
    same_answers(stacked, catalog_answers(cat, buckets),
                 f"{kind} catalog: stacked against sequential")
    cat.parallel = cfg.serve_parallel_segments
    cases = [(f"requests m={P.shape[1]}", P, k) for P in buckets
             for k in (0, LOCATE_K)]
    edge = stacked_edge_cases(st, [s.tokens for s in cat.segments])
    err = check_stacked(st, cases + edge, f"{kind} n={len(toks)}", lanes)
    views = check_views(st, buckets[-1], LOCATE_K, lanes)
    row, measured = None, {}
    if cuda:
        P = pad_patterns(sample_patterns(toks, 1024, seed, 17, 32), 32,
                         device)
        heavy = pad_patterns(sample_patterns(toks, 1024, seed, 3, 8), 8,
                             device)
        row, measured = stacked_measure(
            st, P, heavy, lanes, latency_ns, f"{kind} n={len(toks)} in "
                                             f"{n_seg} segments")
        row["max_abs_err"] = err
    rec = {"kind": kind, "n": len(toks), "segments": n_seg,
           "sigma": cat.segments[0].index.sigma, "bits": st.bits,
           "bucket": want_bytes, "append_s": append_s,
           "build_s": sum(append_s), "stack_and_first_flush_s": stack_s,
           "count_qps": qps["count"], "locate_qps": qps["locate"],
           "requests": {"count": requests, "locate": requests},
           "serve_batches": batches, "launches_build": build_launches,
           "launches_serve": serve, "max_abs_err": err,
           "checks": "stacked == sequential, 16 brute force counts, every "
                     "located position",
           "edge_cases": sorted({f"{w} k={k}" for w, _, k in edge}),
           "views": views, "row": row, **measured, **extra}
    return dict(rec=rec, catalog=cat, pats=pats, launches=launches, row=row)


def stacked_measure(st, P, heavy, lanes, latency_ns, what: str) -> tuple:
    """The stacked kernel on the card at ``P`` (B=1024, m=32) and k =
    LOCATE_K: its kernels-line row (``stacked_timing`` with the latency
    floor beside the bytes bound), and the measurements against the
    pre-redesign kernel: both in turns (``stacked_turns``, also at the
    short patterns ``heavy``: 1024 of 3 to 8 symbols, the flush's m = 8
    bucket, most pairs with every slot live), the segment
    sweep (``stacked_sweep``), registers, resident blocks per SM and waves
    of both launches, and the packed kernel at each tile
    (``plan_trial``)."""
    import torch

    from repro_torch.kernels import fm_query as fq

    t = stacked_timing(st, P, LOCATE_K)
    row = dict(ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
               bound_ms=t["bound_ms"], library_ms=None,
               dependent_steps=t["dependent_steps"],
               **latency_floor(st, P, t["dependent_steps"]["walk"],
                               latency_ns),
               shape=f"{what}: locate B={P.shape[0]}, m={P.shape[1]}, "
                     f"k={LOCATE_K}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    old = occupancy(lanes["stacked_lanes_occupancy"], st)
    blocks = lanes_blocks(st, P.shape[0], LOCATE_K)
    old.update(blocks=blocks, sms=sms,
               waves=waves(blocks, old["blocks_per_sm"], sms))
    new = dict(fq.stacked_occupancy(st))
    tile = (fq.stacked_plan(P.shape[0], st.n_seg, new["blocks_per_sm"] * sms)
            if st.bits else fq.STACKED_THREADS // fq.STACKED_GROUP)
    grid = fq.stacked_grid(P.shape[0], st.seg_pad, tile)
    real = fq.stacked_grid(P.shape[0], st.n_seg, tile)
    new.update(tile=tile, blocks=grid, real_blocks=real,
               waves=waves(real, new["blocks_per_sm"], sms))
    measured = {"in_turns": stacked_turns(st, P, heavy, lanes, latency_ns),
                "occupancy": {"old": old, "new": new},
                "sweep": stacked_sweep(st, P, LOCATE_K, lanes, latency_ns)}
    if st.bits:
        measured["plan_trial"] = plan_trial(st, P, heavy)
    return row, measured


def live_rows(st, P, k: int) -> int:
    """The walks one launch makes: min(ep - sp, k) summed over the real
    (segment, pattern) pairs, from the plain version's intervals."""
    sp, ep, _ = stacked_fns(st)[2](st, P, 0)
    return int((ep - sp)[: st.n_seg].clamp(max=k).sum())


def stacked_turns(st, P, heavy, lanes, latency_ns) -> dict:
    """The port's kernel ("new") and the pre-redesign one ("old") in
    turns (old, new, new, old), L2-cold device ms: at ``P`` and k =
    LOCATE_K, the same for count (k = 0), its first ``SMALL_BATCH``
    patterns, and the short patterns ``heavy`` (most slots live); each
    with its latency floor and live rows."""
    kern = stacked_fns(st)[1]
    out = {}
    for what, Q, k in ((f"B={P.shape[0]}", P, LOCATE_K),
                       (f"B={P.shape[0]} count", P, 0),
                       (f"B={SMALL_BATCH}", P[:SMALL_BATCH], LOCATE_K),
                       (f"B={heavy.shape[0]} m={heavy.shape[1]}", heavy,
                        LOCATE_K)):
        rec = in_turns({"old": lambda: lanes_query(lanes, st, Q, k),
                        "new": lambda: kern(st, Q, k)})
        walk = stacked_query_bytes(st, Q, k)[1]
        rec.update(latency_floor(st, Q, walk, latency_ns),
                   live_rows=live_rows(st, Q, k))
        out[what] = rec
    return out


def plan_trial(st, P, heavy, tiles=(1, 2, 4, 8, 16, 32, 64, 128)) -> dict:
    """The packed kernel at each tile size of ``tiles`` and at the one
    ``fm_query.stacked_plan`` picks for each shape: L2-cold (``cold_ms``)
    device ms at ``P``, its first ``SMALL_BATCH`` patterns and ``heavy``,
    k = LOCATE_K, each answer equal to the plain version's (the plan set
    for the trial and restored)."""
    from repro_torch.kernels import fm_query as fq

    name, kern, plain = stacked_fns(st)
    shapes = {"ms": P, "small_ms": P[:SMALL_BATCH], "heavy_ms": heavy}
    want = {what: plain(st, Q, LOCATE_K) for what, Q in shapes.items()}
    plan, out = fq.stacked_plan, {}
    try:
        for tile in (*tiles, "planned"):
            if tile != "planned":
                fq.stacked_plan = lambda *args, tile=tile: tile
            else:
                fq.stacked_plan = plan
            for what, Q in shapes.items():
                got = kern(st, Q, LOCATE_K)
                for i in range(3):
                    same(got[i], want[what][i], f"{name} tile {tile} {what}")
            out[tile] = {what: cold_ms(lambda: kern(st, Q, LOCATE_K))
                         for what, Q in shapes.items()}
    finally:
        fq.stacked_plan = plan
    return out


def catalog_two_bit(cfg, device, log2n: int, requests: int,
                    n_seg: int = 5, seed: int = 9, lanes=None) -> dict:
    """A small 2-bit catalog (two symbols: with the sentinel and the
    catalog's reserved pad symbol, each segment's sigma is 4) of
    ``n_seg`` segments of unequal length, so that pad segments follow the
    real ones: the 2-bit instantiation of ``fm_query_stacked_packed``
    (and of the pre-redesign kernel, given ``lanes``) against its plain
    version on every flush bucket (k = 0 and LOCATE_K), on
    ``stacked_edge_cases`` and on the n_seg views, and the catalog's
    answers against the sequential path."""
    import numpy as np

    from repro_torch.core.segments import SegmentedIndex

    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 3, (1 << log2n) - 37 * i).astype(np.int32)
            for i in range(n_seg)]
    cat = SegmentedIndex.from_config(3, cfg, device=device)
    for d in docs:
        cat.append(d)
    st = cat._stacked()
    require(st is not None and st.bits == 2 and st.n_seg == n_seg
            and st.seg_pad > n_seg,
            "2-bit catalog: not served through a 2-bit bucket with pad "
            "segments")
    pats = sample_patterns(np.concatenate(docs), requests, seed=seed)
    buckets = flush_buckets(pats, device)
    edge = stacked_edge_cases(st, docs)
    err = check_stacked(st, [(f"m={P.shape[1]}", P, k) for P in buckets
                             for k in (0, LOCATE_K)] + edge, "2-bit", lanes)
    views = check_views(st, buckets[-1], LOCATE_K, lanes)
    stacked = catalog_answers(cat, buckets)
    cat.parallel = False
    same_answers(stacked, catalog_answers(cat, buckets),
                 "2-bit catalog: stacked against sequential")
    return {"segments": n_seg, "seg_pad": st.seg_pad, "bits": st.bits,
            "n": sum(len(d) for d in docs), "requests": len(pats),
            "edge_cases": sorted({f"{w} k={k}" for w, _, k in edge}),
            "views": views, "max_abs_err": err}


def catalog_sweep(kind: str, toks, n_seg: int, cfg, device, lanes,
                  latency_ns, seed: int = 8) -> dict:
    """The corpus as a catalog of ``n_seg`` segments (the launcher's
    --segments split), for the stacked kernels alone: both held to the
    plain version on the n_seg views, then ``stacked_measure``."""
    import numpy as np

    from repro_torch.core.segments import SegmentedIndex

    cat = SegmentedIndex.from_config(int(toks.max()) + 1, cfg,
                                     device=device)
    for chunk in np.array_split(toks, n_seg):
        cat.append(chunk)
    st = cat._stacked()
    require(st is not None and st.n_seg == n_seg,
            f"{kind} sweep catalog: not stacked in {n_seg} segments")
    P = pad_patterns(sample_patterns(toks, 1024, seed, 17, 32), 32, device)
    heavy = pad_patterns(sample_patterns(toks, 1024, seed, 3, 8), 8, device)
    views = check_views(st, P, LOCATE_K, lanes)
    row, measured = stacked_measure(
        st, P, heavy, lanes, latency_ns, f"{kind} n={len(toks)} in "
                                         f"{n_seg} segments")
    return {"kind": kind, "n": len(toks), "segments": n_seg,
            "views": views, "row": row, **measured}


def catalog_growth(cat, docs, pats, device, requests: int = 1024) -> dict:
    """The launcher's synchronous --append on a served catalog: each
    document appended, then ``maybe_compact``.  Answers on patterns from
    the new documents and the old ones, taken before every
    ``maybe_compact``, must equal the answers after a compaction (counts
    and in-k locate sets)."""
    import numpy as np

    new = sample_patterns(np.concatenate(docs), requests // 2, seed=81)
    buckets = flush_buckets(new + pats[: requests // 2], device)
    steps = []
    for d in docs:
        _, append_s = timed(lambda: cat.append(d), device)
        restack = cat._stacked_cache is None
        before, query_s = timed(lambda: catalog_answers(cat, buckets),
                                device)
        merges, compact_s = timed(cat.maybe_compact, device)
        step = dict(tokens=len(d), append_s=append_s, restacked=restack,
                    queries_s=query_s, merges=merges, compact_s=compact_s,
                    segments=len(cat.segments),
                    seg_pad=cat._stacked().seg_pad)
        if merges:
            plan = cat.compact_last_plan
            step["plan"] = {k: plan[k] for k in ("strategy", "requested",
                                                 "reason", "est")}
            same_answers(before, catalog_answers(cat, buckets),
                         "answers across compaction", in_k=True)
        steps.append(step)
    return {"steps": steps, "merges": sum(s["merges"] for s in steps)}


def catalog_kway(sigma: int, docs, cfg, device, merged=None) -> dict:
    """Forced compactions of the same documents on two more catalogs,
    ``compact(strategy="kway")`` (one k-way walk, no fallback) and
    ``compact(strategy="rebuild")``: equal in every field and document
    table, and equal to ``merged`` (the served catalog's compaction of
    them) when given."""
    from repro_torch.core.fm_index import fm_mismatch
    from repro_torch.core.segments import SegmentedIndex

    out = {}
    for strategy in ("kway", "rebuild"):
        cat = SegmentedIndex.from_config(sigma, cfg, device=device)
        for d in docs:
            cat.append(d)
        merges, s = timed(lambda: cat.compact(strategy=strategy), device)
        require(merges == 1 and len(cat.segments) == 1
                and cat.compact_strategy_counts == {strategy: 1}
                and cat.compact_fallbacks == 0,
                f"forced {strategy}: {merges} merges, "
                f"{cat.compact_strategy_counts}, {cat.compact_fallbacks} "
                f"fallbacks")
        out[strategy] = (cat.segments[0], s, cat.compact_last_plan)
    kway, rebuilt = out["kway"][0], out["rebuild"][0]
    for what, seg in (("forced k-way", kway), ("the served catalog's "
                                                "compaction", merged)):
        if seg is None:
            continue
        mm = fm_mismatch(seg.index.fm, rebuilt.index.fm)
        require(mm == [], f"{what} != the rebuild: {mm}")
        require(seg.docs == rebuilt.docs,
                f"{what}: document table differs from the rebuild's")
    return {"kway_s": out["kway"][1], "rebuild_s": out["rebuild"][1],
            "walk_steps": out["kway"][2]["actual_walk_steps"],
            "merged_n": kway.index.fm.length, "fm_mismatch": [],
            "served_compaction_checked": merged is not None}


def catalog_save_load(cat, extra_doc, pats, device) -> dict:
    """Save the catalog to a temporary directory under build/ (removed
    afterwards), load it back: the same catalog and the same answers.
    Then one more append and a second save, which must add only the new
    segment's files and leave every earlier segment file untouched."""
    import torch

    from repro_torch.core.segments import SegmentedIndex

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(dir=build, prefix="catalog_"))
    buckets = flush_buckets(pats, device)
    try:
        _, save_s = timed(lambda: cat.save(str(d)), device)
        nbytes = dir_bytes(d)
        loaded, load_s = timed(
            lambda: SegmentedIndex.load(str(d), device=device), device)
        require(not loaded.degraded and loaded.catalog() == cat.catalog(),
                "loaded catalog differs")
        same_answers(catalog_answers(cat, buckets),
                     catalog_answers(loaded, buckets), "save -> load")
        del loaded

        def seg_files():
            return {p.relative_to(d).as_posix(): p.stat().st_mtime_ns
                    for p in d.rglob("*")
                    if p.is_file() and p.relative_to(d).parts[0]
                    .startswith("seg_")}

        before = seg_files()
        seg = cat.append(extra_doc)
        _, save2_s = timed(lambda: cat.save(str(d)), device)
        after = seg_files()
        name = f"seg_{seg.seg_id:06d}/"
        added = set(after) - set(before)
        require(set(before) <= set(after), "second save removed files")
        require(added and all(p.startswith(name) for p in added),
                f"second save wrote outside {name}: {sorted(added)}")
        require(all(after[p] == before[p] for p in before),
                "second save rewrote an earlier segment's file")
        return {"save_s": save_s, "bytes_on_disk": nbytes,
                "load_s": load_s, "second_save_s": save2_s,
                "second_save_files": len(added)}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_catalog(dna_toks, proteins_log2n: int, merge_log2n: int,
                  device="cuda", requests: int = 1024, lanes=None,
                  chase=None):
    """Phase 8: (a) the DNA corpus in ``DNA_SEGMENTS`` segments
    (``catalog_path``), then phase 7's eight documents appended with
    ``maybe_compact`` (``catalog_growth``), forced k-way and rebuild
    compactions of them on two more catalogs (``catalog_kway``) and save
    -> load (``catalog_save_load``); (b) proteins in ``PROTEIN_SEGMENTS``
    segments, and on the card the same corpus in 16 segments for the
    stacked kernel's segment sweep (``catalog_sweep``); (c) a small 2-bit
    catalog (``catalog_two_bit``).  ``lanes`` (the pre-redesign stacked
    kernel) and ``chase`` (the pointer chase, for the latency floors) are
    the card's.  The
    config is the card's, with ``segment_min_tokens`` cut
    to a segment's size when the corpus is (a reduced run) and the
    documents kept under it.  At full size the eight documents compact
    exactly once, at the eighth (the ``compact_max_small`` backstop).
    Returns (record, launches per path, kernels-line rows)."""
    import functools

    import torch

    from repro_torch.data.corpus import corpus

    cuda = torch.device(device).type == "cuda"
    latency_ns = None
    if chase is not None:
        latency_ns = functools.lru_cache(maxsize=None)(
            functools.partial(dependent_load_ns, chase))
    cfg, full, top, docs = catalog_config(len(dna_toks), merge_log2n)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    a = catalog_path("dna", dna_toks, DNA_SEGMENTS, cfg, device, requests,
                     lanes=lanes, latency_ns=latency_ns)
    cat = a["catalog"]
    growth = catalog_growth(cat, docs, a["pats"], device, requests)
    require(growth["merges"] >= 1, "growth: the run never compacted")
    if full:
        require(growth["merges"] == 1 and growth["steps"][-1]["merges"] == 1
                and len(cat.segments) == DNA_SEGMENTS + 1,
                f"growth: {growth['merges']} compactions, "
                f"{len(cat.segments)} segments")
    kway = catalog_kway(cat.sigma, docs, cfg, device,
                        cat.segments[DNA_SEGMENTS] if full else None)
    io_rec = catalog_save_load(
        cat, corpus("dna", 1 << (top - 3), seed=200), a["pats"], device)
    rec_a = {**a["rec"], "growth": growth, "forced_kway": kway,
             "save_load": io_rec}
    if cuda:
        rec_a["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del a["catalog"], cat
    if cuda:
        torch.cuda.empty_cache()
    prot = corpus("proteins", 1 << proteins_log2n)
    b = catalog_path("proteins", prot, PROTEIN_SEGMENTS, cfg, device,
                     requests, lanes=lanes, latency_ns=latency_ns)
    del b["catalog"]
    sweep16 = None
    if cuda:
        sweep16 = catalog_sweep("proteins", prot, DNA_SEGMENTS, cfg, device,
                                lanes, latency_ns)
    two_bit = catalog_two_bit(cfg, device, min(16, proteins_log2n - 2),
                              requests // 4, lanes=lanes)
    if a["row"] is not None:
        a["row"]["max_abs_err"] = max(a["row"]["max_abs_err"],
                                      two_bit["max_abs_err"])
    launches = {"catalog_dna": a["launches"],
                "catalog_proteins": b["launches"]}
    rows = {"fm_query_stacked_packed": a["row"],
            "fm_query_stacked_unpacked": b["row"]}
    return ({"dna": rec_a, "proteins": b["rec"], "two_bit": two_bit,
             "proteins_16_segments": sweep16}, launches, rows)


# --------------------------------------------------------------------------
# phase 9: the async frontend, the launcher's --serve-async, dedup
# --------------------------------------------------------------------------

FRONTEND_REQUESTS = 1 << 14    # per scenario
FRONTEND_CLIENTS = 64          # closed-loop client threads
LOCATE_FRAC = 0.2              # share of locate requests (k = LOCATE_K)
OVERLOAD_QUEUE = 64            # the overload scenario's admission bound
RESULT_TIMEOUT_S = 120
# the build kernels a live append (and a compaction by rebuild) launches
BUILD_KERNELS = ("radix_hist", "radix_pos", "rerank_scan", "char_histogram")


def frontend_requests(toks, count: int, seed: int):
    """``count`` (pattern, kind) requests: substrings of ``toks`` of
    lengths 3-32, each a locate with probability ``LOCATE_FRAC``."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xF9]))
    pats = sample_patterns(toks, count, seed, hi=min(32, len(toks) - 1))
    return [(p, "locate" if rng.random() < LOCATE_FRAC else "count")
            for p in pats]


def direct_answers(index, reqs, device, batch: int = 1024):
    """(counts int64[N], positions int64[N, LOCATE_K]) of the requests'
    patterns by direct ``index.count`` / ``index.locate`` calls, ``batch``
    patterns at a time: called before a frontend starts or after it
    stops, never while its worker dispatches."""
    import numpy as np

    pats = [p for p, _ in reqs]
    L = max(len(p) for p in pats)
    counts, pos = [], []
    for lo in range(0, len(pats), batch):
        P = pad_patterns(pats[lo: lo + batch], L, device)
        counts.append(index.count(P).cpu().numpy().astype(np.int64))
        pos.append(index.locate(P, LOCATE_K)[0].cpu().numpy().astype(
            np.int64))
    return np.concatenate(counts), np.concatenate(pos)


def outcome(fut):
    """A future's result, or the exception it resolved to."""
    try:
        return fut.result(timeout=RESULT_TIMEOUT_S)
    except Exception as e:  # noqa: BLE001 — the caller checks every one
        return e


def submit(fe, req):
    pat, kind = req
    return fe.submit(pat, kind, k=LOCATE_K if kind == "locate" else None)


def run_closed(fe, reqs, clients: int):
    """``clients`` threads, each submitting its share of ``reqs`` and
    waiting for each answer before the next: (outcomes, wall s)."""
    import threading

    results = [None] * len(reqs)

    def client(start):
        for i in range(start, len(reqs), clients):
            results[i] = outcome(submit(fe, reqs[i]))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10 * RESULT_TIMEOUT_S)
        require(not t.is_alive(), "closed loop: a client thread hung")
    return results, time.perf_counter() - t0


def run_open(fe, reqs, target_qps):
    """Requests on a fixed-rate schedule, not waiting for answers
    (``target_qps`` None: an unpaced burst), then every answer:
    (outcomes, wall s)."""
    futs = []
    interval = 1.0 / target_qps if target_qps else 0.0
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        delay = t0 + i * interval - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futs.append(submit(fe, req))
    results = [outcome(f) for f in futs]
    return results, time.perf_counter() - t0


def no_failure(what: str, results) -> None:
    """No future resolved to an exception: the worker catches dispatch
    errors into futures, so this is what keeps a device fault from
    passing unseen."""
    raised = [(i, r) for i, r in enumerate(results)
              if isinstance(r, BaseException)]
    require(not raised, f"{what}: {len(raised)} futures raised, first "
                        f"{raised[:1]}")


def answer_is(r, kind: str, count: int, pos) -> bool:
    """``r`` is the direct answer: a count, or a locate's clipped count
    and its first positions."""
    import numpy as np

    if type(r).__name__ != "FMQueryResult" or r.kind != kind:
        return False
    if kind == "count":
        return r.count == count
    return r.count == min(count, LOCATE_K) and np.array_equal(
        np.asarray(r.positions, np.int64), pos[: r.count])


def check_served(what: str, reqs, results, counts, pos,
                 allow_shed: bool = False) -> int:
    """Every result equal to the direct answer (``counts``, ``pos``); a
    ``Rejected`` only under ``allow_shed``.  Returns the shed count."""
    from repro_torch.serving.frontend import Rejected

    no_failure(what, results)
    shed = sum(isinstance(r, Rejected) for r in results)
    require(allow_shed or not shed, f"{what}: {shed} requests shed")
    for i, ((_, kind), r) in enumerate(zip(reqs, results)):
        require(isinstance(r, Rejected)
                or answer_is(r, kind, counts[i], pos[i]),
                f"{what}: request {i} ({kind}) resolved to {r!r}, direct "
                f"count {counts[i]}")
    return shed


def bucket_summary(m) -> dict:
    """Per-bucket p50/p99 beside their SLOs, and the worst per kind."""
    out = {"buckets": {k: {f: b[f] for f in ("completed", "p50_ms",
                                             "p99_ms", "slo_p99_ms",
                                             "slo_ok", "violations")}
                       for k, b in m["buckets"].items()}}
    for kind in ("count", "locate"):
        rows = [b for k, b in m["buckets"].items()
                if k.startswith(kind + "/") and b["completed"]]
        if rows:
            out[f"{kind}_p50_ms"] = max(b["p50_ms"] for b in rows)
            out[f"{kind}_p99_ms"] = max(b["p99_ms"] for b in rows)
            out[f"{kind}_slo_ok"] = all(b["slo_ok"] for b in rows)
    return out


def served(what: str, new_frontend, server, scenario, qname: str,
           allowed=()) -> tuple:
    """``scenario(fe)`` -> (results, wall s, extra record) on a new
    frontend over ``server``, launch counts set to 0 just before it and
    read after it stops: one ``qname`` launch per served bucket chunk, no
    other kernel but ``allowed``, no worker restart.  Returns (results,
    metrics, launches, record)."""
    from repro_torch.kernels import _build

    b0 = server.stats.batches
    _build.reset_launches()
    with new_frontend() as fe:
        results, wall, extra = scenario(fe)
    launches = dict(_build.LAUNCHES)
    m = fe.metrics()
    chunks = server.stats.batches - b0
    cuda = server.device.type == "cuda"
    require(launches[qname] == (chunks if cuda else 0),
            f"{what}: {launches[qname]} {qname} launches for {chunks} "
            f"served bucket chunks")
    others = {k: v for k, v in launches.items()
              if v and k != qname and k not in allowed}
    require(not others, f"{what}: other kernels launched: {others}")
    require(m["worker_restarts"] == 0,
            f"{what}: {m['worker_restarts']} worker restarts")
    rec = {"requests": len(results), "wall_s": wall,
           "qps": m["completed"] / wall, "admitted": m["admitted"],
           "rejected": m["rejected"], "shed_frac": m["shed_frac"],
           "completed": m["completed"], "flushes": m["flushes"],
           "mean_batch": m["completed"] / max(m["flushes"], 1),
           "bucket_chunks": chunks,
           "launches_per_flush": launches[qname] / max(m["flushes"], 1),
           **extra, **bucket_summary(m)}
    return results, m, launches, rec


def closed(reqs, clients):
    return lambda fe: (*run_closed(fe, reqs, clients), {"clients": clients})


def profiled_window(new_frontend, reqs, clients: int, qname: str,
                    tries: int = 3):
    """A closed-loop window under torch.profiler: the device-busy share
    (summed device time of its kernel rows over its wall), given only
    when the profiler recorded as many ``qname`` launches as the wrapper
    counted (the worker thread's launches must be seen); a window whose
    profile lost records is taken again, up to ``tries`` times.  Returns
    (the last window's results, record)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    seen_counts = []
    for _ in range(tries):
        _build.reset_launches()
        with new_frontend() as fe:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                results, wall = run_closed(fe, reqs, clients)
                torch.cuda.synchronize()
        counted = _build.LAUNCHES[qname]
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        seen = sum(c for k, _, c in rows if qname in k)
        dev_us = sum(t for _, t, _ in rows)
        seen_counts.append((seen, counted))
        if seen == counted:
            break
    return results, {
        "requests": len(reqs), "clients": clients, "wall_s": wall,
        "launches_profiled_counted": seen_counts, "device_s": dev_us / 1e6,
        "device_busy_share": dev_us / (wall * 1e6) if seen == counted else
        "not measured: the profiler lost launch records"}


def frontend_single(index, toks, cfg, device, requests: int, clients: int):
    """(a) The single index behind ``FMQueryServer.from_config`` and
    ``AsyncQueryFrontend.from_config``: closed loop, open loop at 70% of
    its qps, an unpaced burst into a 64-deep queue; a profiled
    closed-loop window; the sync flush of the same requests.  (c) its
    faults.  Returns (record, launches per scenario)."""
    from repro_torch.serving.engine import FMQueryServer
    from repro_torch.serving.frontend import AsyncQueryFrontend

    server = FMQueryServer.from_config(index, cfg.replace(locate_k=LOCATE_K),
                                       device=device)
    qname = query_fns(index.fm)[0]
    sets = {name: frontend_requests(toks, requests, seed)
            for seed, name in enumerate(("closed", "open", "overload"), 90)}
    want = {name: direct_answers(index, reqs, device)
            for name, reqs in sets.items()}
    server.count([p for p, _ in sets["closed"][:8]])      # warm-up
    server.locate([p for p, _ in sets["closed"][:8]])

    def frontend(**kw):
        return lambda: AsyncQueryFrontend.from_config(server, cfg, **kw)

    out, launches = {}, {}
    reqs = sets["closed"]
    res, _, launches["frontend_closed"], out["closed"] = served(
        "closed loop", frontend(max_queue=1 << 16), server,
        closed(reqs, clients), qname)
    check_served("closed loop", reqs, res, *want["closed"])
    target = max(out["closed"]["qps"] * 0.7, 1.0)
    reqs = sets["open"]
    res, _, launches["frontend_open"], out["open"] = served(
        "open loop", frontend(max_queue=1 << 16), server,
        lambda fe: (*run_open(fe, reqs, target), {"target_qps": target}),
        qname)
    check_served("open loop", reqs, res, *want["open"])
    reqs = sets["overload"]
    res, m, launches["frontend_overload"], out["overload"] = served(
        "overload", frontend(max_queue=OVERLOAD_QUEUE, max_wait_ms=0.5),
        server, lambda fe: (*run_open(fe, reqs, None),
                            {"max_queue": OVERLOAD_QUEUE,
                             "max_wait_ms": 0.5}), qname)
    shed = check_served("overload", reqs, res, *want["overload"],
                        allow_shed=True)
    require(shed > 0 and m["rejected"] == shed,
            f"overload: {shed} shed, {m['rejected']} rejected")
    if device.type == "cuda":
        window = sets["closed"][: requests // 4]
        res, out["profiled_window"] = profiled_window(
            frontend(max_queue=1 << 16), window, clients, qname)
        check_served("profiled window", window, res, *want["closed"])
    # the sync FMQueryServer.flush of the same requests, one call per kind
    out["sync_flush_qps"] = {}
    for kind in ("count", "locate"):
        idx = [i for i, (_, k) in enumerate(sets["closed"]) if k == kind]
        pats = [sets["closed"][i][0] for i in idx]
        q0, s0 = server.stats.queries, server.stats.seconds
        tickets = [server.submit(p, kind) for p in pats]
        got = server.flush()
        out["sync_flush_qps"][kind] = (server.stats.queries - q0) / (
            server.stats.seconds - s0)
        counts, pos = want["closed"]
        require(all(answer_is(got[t], kind, counts[i], pos[i])
                    for t, i in zip(tickets, idx)),
                f"sync flush: {kind} answers differ from direct")
    out["faults"] = frontend_faults(server, cfg, sets["closed"],
                                    *want["closed"])
    return out, launches


def frontend_faults(server, cfg, reqs, counts, pos) -> dict:
    """(c) ``worker.flush`` armed at its first hit: that flush's futures
    (a prefix of the submissions) fail with ``InjectedFault``, one worker
    restart, and the rest of that wave and a second wave submitted after
    it are answered exactly by the respawned worker; ``deadline_ms=0``
    behind a full batch gives ``DeadlineExceeded``; ``stop()`` with
    requests pending resolves every admitted future."""
    from repro_torch.serving.frontend import AsyncQueryFrontend
    from repro_torch.serving.frontend import DeadlineExceeded
    from repro_torch.testing import faultinject as fi

    out = {}
    n = min(256, len(reqs) // 2)
    with fi.inject(fi.FaultSchedule([("worker.flush", 0)])) as sched:
        with AsyncQueryFrontend.from_config(server, cfg) as fe:
            res = []
            for wave in (reqs[:n], reqs[n: 2 * n]):
                futs = [submit(fe, r) for r in wave]
                res += [outcome(f) for f in futs]
            m = fe.metrics()
    crashed = [i for i, r in enumerate(res) if isinstance(r, BaseException)]
    require(crashed and crashed == list(range(len(crashed)))
            and len(crashed) <= n
            and all(isinstance(res[i], fi.InjectedFault) for i in crashed),
            f"worker crash: failed futures {crashed[:8]}... are not the "
            f"first flush's, or not the injected fault")
    k = len(crashed)
    check_served("worker crash: the other flushes", reqs[k: 2 * n],
                 res[k:], counts[k:], pos[k:])
    require(m["worker_restarts"] == 1 and m["completed"] == 2 * n - k
            and sched.fired == [("worker.flush", 0)],
            f"worker crash: {m['worker_restarts']} restarts, "
            f"{m['completed']} completed, fired {sched.fired}")
    out["worker_crash"] = {"requests": 2 * n, "failed_first_flush": k,
                           "worker_restarts": m["worker_restarts"],
                           "completed": m["completed"]}

    full = min(server.max_batch, len(reqs))
    fe = AsyncQueryFrontend.from_config(server, cfg, autostart=False)
    futs = [submit(fe, r) for r in reqs[:full]]
    doomed = fe.submit(reqs[0][0], "count", deadline_ms=0.0)
    time.sleep(0.005)
    fe.start()
    late = outcome(doomed)
    fe.stop()
    require(isinstance(late, DeadlineExceeded),
            f"deadline: resolved to {late!r}")
    check_served("deadline: the full batch", reqs[:full],
                 [outcome(f) for f in futs], counts, pos)
    m = fe.metrics()
    require(m["deadline_exceeded"] == 1 and m["completed"] == full,
            f"deadline: {m['deadline_exceeded']} expired, "
            f"{m['completed']} completed")
    out["deadline"] = {"batch": full, "result": type(late).__name__}

    n = min(256, len(reqs))
    fe = AsyncQueryFrontend.from_config(server, cfg, max_wait_ms=200.0)
    futs = [submit(fe, r) for r in reqs[:n]]
    pending = fe.queue_depth
    fe.stop()
    require(all(f.done() for f in futs), "stop: an admitted future is "
                                         "still pending")
    check_served("stop with requests pending", reqs[:n],
                 [outcome(f) for f in futs], counts, pos)
    out["stop_pending"] = {"requests": n, "queued_at_stop": pending,
                           "resolved": n}
    return out


def growth_requests(toks, docs, per: int):
    """Requests of the live-append run in ``len(docs) + 1`` epochs of
    ``per``: epoch e starts once append e - 1 resolved; its second half
    comes from the newest appended document (epoch 0: all from the
    corpus)."""
    reqs = []
    for e in range(len(docs) + 1):
        half = per // 2 if e else 0
        reqs += frontend_requests(toks, per - half, 200 + e)
        if half:
            reqs += frontend_requests(docs[e - 1], half, 300 + e)
    return reqs


def run_growth(fe, reqs, docs, per: int, target_qps):
    """The open loop with live appends: epoch by epoch (``per`` requests
    each, paced at ``target_qps``), document e appended halfway through
    epoch e without waiting, its answer awaited at the epoch's end.  Each
    request records the appends resolved when it was submitted and the
    appends submitted when it resolved: the catalog state its answer
    reflects lies between.  Returns (results, wall, extra record)."""
    state = {"submitted": 0, "resolved": 0}
    window = [[0, 0] for _ in reqs]
    futs, infos, append_s = [], [], []
    interval = 1.0 / target_qps
    t0 = time.perf_counter()
    for e in range(len(docs) + 1):
        pending = None
        for i in range(e * per, (e + 1) * per):
            if e < len(docs) and i == e * per + per // 2:
                state["submitted"] += 1       # before: an upper bound
                t_append = time.perf_counter()
                pending = fe.append(docs[e])
                pending.add_done_callback(
                    lambda f, t=t_append: append_s.append(
                        time.perf_counter() - t))
            delay = t0 + i * interval - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            window[i][0] = state["resolved"]
            fut = submit(fe, reqs[i])
            fut.add_done_callback(lambda f, w=window[i]: w.__setitem__(
                1, state["submitted"]))
            futs.append(fut)
        if pending is not None:
            infos.append(outcome(pending))
            state["resolved"] += 1
    results = [outcome(f) for f in futs]
    return results, time.perf_counter() - t0, {
        "target_qps": target_qps, "epochs": len(docs) + 1,
        "appends": infos, "append_s": append_s,
        "window": window}


def growth_answers(base, doc_answers, offsets, final, compacted):
    """The direct answer of each request at catalog state a (a documents
    appended): counts add up per document; positions are the smallest k
    of the corpus's and each document's (shifted to its offset) while no
    compaction has merged segments, the final catalog's at the last
    state, and unknown (None) in between.  Returns want(i, a)."""
    import numpy as np

    bc, bp = base

    def want(i, a):
        c = int(bc[i] + sum(int(dc[i]) for dc, _ in doc_answers[:a]))
        if a == len(doc_answers):
            return c, final[1][i]
        if any(compacted[:a]):
            return c, None
        cand = [bp[i][: min(int(bc[i]), LOCATE_K)]]
        for (dc, dp), off in zip(doc_answers[:a], offsets):
            cand.append(dp[i][: min(int(dc[i]), LOCATE_K)] + off)
        return c, np.sort(np.concatenate(cand))[:LOCATE_K]

    return want


def frontend_catalog(toks, docs, cfg, full: bool, device, requests: int,
                     clients: int):
    """(b) The DNA corpus as a ``DNA_SEGMENTS``-segment catalog (the
    launcher's split): the closed loop, then the open loop while
    ``fe.append`` adds phase 7's eight documents one by one.  Every
    answer equals the direct answer of a catalog state between the
    appends resolved at its submission and those submitted at its
    resolution; requests submitted after an append resolved see its
    text.  Returns (record, launches per scenario)."""
    import numpy as np

    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.serving.engine import FMQueryServer
    from repro_torch.serving.frontend import AsyncQueryFrontend

    cat = SegmentedIndex.from_config(int(toks.max()) + 1, cfg, device=device)
    _, build_s = timed(lambda: [cat.append(c) for c in
                                np.array_split(toks, DNA_SEGMENTS)], device)
    server = FMQueryServer.from_config(cat, cfg.replace(locate_k=LOCATE_K),
                                       device=device)
    reqs = frontend_requests(toks, requests, 95)
    want = direct_answers(cat, reqs, device)               # stacks
    qname = stacked_fns(cat._stacked())[0]
    out, launches = {"segments": DNA_SEGMENTS, "build_s": build_s}, {}
    res, _, launches["frontend_catalog_closed"], out["closed"] = served(
        "catalog closed loop",
        lambda: AsyncQueryFrontend.from_config(server, cfg, max_queue=1 << 16),
        server, closed(reqs, clients), qname)
    check_served("catalog closed loop", reqs, res, *want)

    per = requests // (len(docs) + 1)
    reqs = growth_requests(toks, docs, per)
    base = direct_answers(cat, reqs, device)
    # each document's answers from its own segment build, before the
    # frontend starts; its global offset as append assigns it
    doc_answers, offsets, off = [], [], cat.coord_end
    for d in docs:
        doc_answers.append(direct_answers(cat._build(d), reqs, device))
        offsets.append(off)
        off += len(d)
    target = max(out["closed"]["qps"] * 0.7, 1.0)
    res, m, launches["frontend_catalog_growth"], rec = served(
        "catalog growth",
        lambda: AsyncQueryFrontend.from_config(server, cfg, max_queue=1 << 16),
        server, lambda fe: run_growth(fe, reqs, docs, per, target), qname,
        allowed=BUILD_KERNELS)
    infos, window = rec.pop("appends"), rec.pop("window")
    no_failure("catalog growth: appends", infos)
    final = direct_answers(cat, reqs, device)
    compacted = [info["merges"] > 0 for info in infos]
    want = growth_answers(base, doc_answers, offsets, final, compacted)
    no_failure("catalog growth", res)
    ambiguous = seen_new = 0
    for i, ((_, kind), r) in enumerate(zip(reqs, res)):
        lo, hi = window[i]
        ok = False
        for a in range(lo, hi + 1):
            c, p = want(i, a)
            if p is None and kind == "locate":
                # between a compaction and the last state only the count
                # and the positions' order are known
                ok |= (r.count == min(c, LOCATE_K)
                       and bool(np.all(np.diff(r.positions) > 0)))
            else:
                ok |= answer_is(r, kind, c, p)
        require(ok, f"catalog growth: request {i} ({kind}, appends "
                    f"{lo}..{hi}) resolved to {r!r}")
        ambiguous += hi > lo
        if i % per >= per - per // 2 and i >= per:
            seen_new += 1
            require(r.count >= 1, f"catalog growth: request {i} does not "
                                  f"see its appended document")
    require(final[0].tolist() == [want(i, len(docs))[0]
                                  for i in range(len(reqs))],
            "catalog growth: final counts != corpus + documents")
    if full:
        require(compacted == [False] * (len(docs) - 1) + [True]
                and len(cat.segments) == DNA_SEGMENTS + 1,
                f"catalog growth: compactions {compacted}, "
                f"{len(cat.segments)} segments")
    out["growth"] = {**rec, "appends": len(infos),
                     "append_merges": [info["merges"] for info in infos],
                     "segments_after": len(cat.segments),
                     "compactions": m["compactions"],
                     "compact_strategy_counts": m["compact_strategy_counts"],
                     "requests_between_states": ambiguous,
                     "requests_on_appended_text": seen_new}
    del cat, server
    return out, launches


def frontend_launcher(doc, device, log2n: int) -> tuple[dict, dict]:
    """(d) ``launch.serve --serve-async --segments 4 --append <doc>
    --ckpt-dir`` at n = 2^log2n, then the saved catalog reloaded: it
    holds the appended text (brute-force counts of 64 of its patterns,
    every located position)."""
    import numpy as np

    from repro_torch.configs.bwt_index import CONFIG
    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving.engine import FMQueryServer

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build, prefix="chip_smoke_async_"))
    try:
        np.save(tmp / "doc.npy", doc)
        argv = ["--kind", "dna", "--n", str(1 << log2n), "--serve-async",
                "--segments", "4", "--append", str(tmp / "doc.npy"),
                "--ckpt-dir", str(tmp / "cat"), "--device", device.type]
        buf = io.StringIO()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = serve.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        m = got["metrics"]
        require(m["appends"] == 1 and m["worker_restarts"] == 0
                and m["rejected"] == 0 and got["total_hits"] > 0,
                f"launcher --serve-async: {m}")
        text = buf.getvalue()
        require("async-serve:" in text and "segmented catalog saved" in text,
                "launcher --serve-async: no serve or save line")
        cat = SegmentedIndex.load(str(tmp / "cat"), device=device)
        require(cat.total_tokens == (1 << log2n) + len(doc)
                and np.array_equal(cat.segments[-1].tokens[-len(doc):], doc),
                "reloaded catalog does not hold the appended document")
        pats = sample_patterns(doc, 64, seed=97, hi=min(32, len(doc) - 1))
        server = FMQueryServer.from_config(
            cat, CONFIG.replace(locate_k=LOCATE_K), device=device)
        counts = [int(x) for x in server.count(pats)]
        check_catalog_answers(cat, pats, counts, server.locate(pats),
                              n_brute=64)
        return {"argv": " ".join(argv[:7] + ["--append", "DOC",
                                             "--ckpt-dir", "DIR"]),
                "wall_s": wall,
                "total_hits": got["total_hits"],
                "completed": m["completed"], "qps": m["qps"],
                "flushes": m["flushes"], "segments": got["segments"],
                "reloaded_tokens": cat.total_tokens,
                "lines": [ln for ln in text.splitlines()
                          if not ln.startswith((" ", "{", "}"))]}, launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def window_counts(toks_dev, starts, w: int):
    """Brute-force occurrence counts of the ``w``-token windows at
    ``starts`` (w even, symbols < 8): each window as two 3-bit packed
    keys of w / 2 symbols, compared at every text position."""
    import torch

    require(w % 2 == 0 and int(toks_dev.max()) < 8
            and int(toks_dev.min()) >= 0, "window_counts: w even, 3 bits")
    t = toks_dev.to(torch.int64)
    h, n = w // 2, t.shape[0]
    key = torch.zeros(n - h + 1, dtype=torch.int64, device=t.device)
    for j in range(h):
        key |= t[j: j + n - h + 1] << (3 * j)
    nw = n - w + 1
    a, b = key[:nw], key[h: h + nw]
    return torch.stack([((a == a[s]) & (b == b[s])).sum()
                        for s in starts.tolist()]).cpu().numpy()


def frontend_dedup(device, log2n: int, plant_log2n: int,
                   samples: int = 1024, evals: int = 1024,
                   eval_len: int = 256) -> tuple[dict, dict]:
    """(e) DNA 2^log2n tokens with their first 2^plant_log2n planted
    again at the end: ``duplicate_window_mask(window=32, stride=32,
    batch=4096)`` flags every window inside both copies, and ``samples``
    sampled windows match brute-force counts; ``contamination_report``
    on ``evals`` sequences of ``eval_len``, every even one cut from the
    corpus (reported), every odd one shifted out of the alphabet (not)."""
    import numpy as np
    import torch

    from repro_torch.data.corpus import corpus
    from repro_torch.data.dedup import (
        build_corpus_index,
        contamination_report,
        duplicate_window_mask,
    )
    from repro_torch.kernels import _build

    cuda = device.type == "cuda"
    base = corpus("dna", 1 << log2n)
    plant = 1 << plant_log2n
    toks = np.concatenate([base, base[:plant]])
    n = len(toks)
    index, build_s = timed(lambda: build_corpus_index(toks, device=device),
                           device)
    qname = query_fns(index.fm)[0]
    _build.reset_launches()
    mask, mask_s = timed(lambda: duplicate_window_mask(
        index, toks, window=32, stride=32, batch=4096), device)
    launches = dict(_build.LAUNCHES)
    starts = np.arange(0, n - 32, 32)
    batches = -(-len(starts) // 4096)
    require(launches[qname] == (batches if cuda else 0)
            and sum(launches.values()) == launches[qname],
            f"dedup: {launches} for {batches} batches")
    inside = starts[(starts + 32 <= plant)
                    | ((starts >= len(base)) & (starts + 32 <= n))]
    require(bool(mask[inside].all()), "dedup: a window inside a planted "
                                      "copy is not flagged")
    rng = np.random.default_rng(np.random.SeedSequence([log2n, 0xDED]))
    pick = np.sort(rng.choice(starts, min(samples, len(starts)),
                              replace=False))
    pats = toks[pick[:, None] + np.arange(32)[None, :]]
    counts = index.count(pats).cpu().numpy()
    brute = window_counts(torch.as_tensor(toks, device=device), pick, 32)
    require(np.array_equal(counts, brute), "dedup: sampled window counts "
                                           "differ from brute force")
    require(np.array_equal(mask[pick], brute >= 2),
            "dedup: mask differs from brute-force duplicates")
    seqs = []
    for j in range(evals):
        st = int(rng.integers(0, len(base) - eval_len))
        seqs.append(base[st: st + eval_len].copy() if j % 2 == 0 else
                    rng.integers(1, 5, eval_len).astype(np.int32) + 10)
    _build.reset_launches()
    rep, report_s = timed(lambda: contamination_report(index, seqs), device)
    launches_report = dict(_build.LAUNCHES)
    require(rep["contaminated"] == list(range(0, evals, 2)),
            "contamination: reported set differs from the cut sequences")
    require(launches_report[qname] == (1 if cuda else 0),
            f"contamination: {launches_report[qname]} {qname} launches")
    launches[qname] += launches_report[qname]
    return {"n": n, "planted": plant, "build_s": build_s,
            "windows": len(starts), "flagged": int(mask.sum()),
            "mask_s": mask_s, "mask_batches": batches,
            "sampled_windows": len(pick),
            "sampled_duplicates": int((brute >= 2).sum()),
            "eval_sequences": evals, "probes": evals * (eval_len // 32),
            "report_s": report_s,
            "contaminated": len(rep["contaminated"])}, launches


def park(index, device):
    """Phase 2's index with its FM index, BWT and row moved to
    ``device`` and no suffix array (serving reads none): phases 7-8 run
    with it parked on the host, so their device memory reads as before."""
    import dataclasses

    import torch

    fm = index.fm
    fm = dataclasses.replace(fm, **{
        f.name: getattr(fm, f.name).to(device)
        for f in dataclasses.fields(fm)
        if isinstance(getattr(fm, f.name), torch.Tensor)})
    return dataclasses.replace(index, fm=fm, sa=None,
                               bwt=index.bwt.to(device),
                               row=index.row.to(device))


def phase_frontend(index, toks, merge_log2n: int, device="cuda",
                   requests: int = FRONTEND_REQUESTS,
                   clients: int = FRONTEND_CLIENTS, launcher_log2n: int = 24,
                   dedup_log2n: int = 24, plant_log2n: int = 20):
    """Phase 9 on ``index`` (phase 2's DNA index over ``toks``): (a) + (c)
    ``frontend_single``, (b) ``frontend_catalog``, (d)
    ``frontend_launcher``, (e) ``frontend_dedup``.  Returns (record,
    launches per path)."""
    import torch

    from repro_torch.configs.bwt_index import CONFIG

    dev = torch.device(device)
    cfg, full, _, docs = catalog_config(len(toks), merge_log2n)
    rec, launches = {}, {}
    rec["single"], got = frontend_single(index, toks, CONFIG, dev, requests,
                                         clients)
    launches.update(got)
    rec["catalog"], got = frontend_catalog(toks, docs, cfg, full, dev,
                                           requests, clients)
    launches.update(got)
    rec["launcher"], launches["frontend_launcher"] = frontend_launcher(
        docs[0], dev, launcher_log2n)
    rec["dedup"], launches["dedup"] = frontend_dedup(dev, dedup_log2n,
                                                     plant_log2n)
    return rec, launches


# --------------------------------------------------------------------------
# phase 10: the distributed build and query (build_index(tokens, mesh))
# --------------------------------------------------------------------------

DIST_PARTS = (4, 2)              # gloo ranks sharing the card: the first
                                 # world saves, the last restores
DIST_SAVED = "dna_bitonic"       # the build the first world saves
DIST_OVERFLOW_FACTOR = 0.5       # a samplesort start that overflows
DIST_RETRIES = 4                 # 0.5 -> 1 -> 2 -> 4
DIST_WORLD_TIMEOUT_S = 600
DIST_NEEDED = {"dna": ("radix_hist", "radix_pos", "char_histogram",
                       "rank_packed"),
               "proteins": ("radix_hist", "radix_pos", "char_histogram",
                            "rank_select")}


def require_dist_launches(launches: dict, kind: str, cuda: bool,
                          what: str) -> None:
    """On the card every kernel of the kind's distributed path launched;
    on the CPU (plain versions) none did."""
    for k, v in launches.items():
        if cuda:
            require(v > 0 or k not in DIST_NEEDED[kind],
                    f"{what}: kernel {k} never launched")
        else:
            require(v == 0, f"{what}: kernel {k} launched on the CPU")


def dist_builds(dna_log2n: int, proteins_log2n: int) -> dict:
    """The builds of a world of ranks sharing the card: name -> (kind,
    log2 n, engine, capacity factor)."""
    return {"dna_bitonic": ("dna", dna_log2n, "bitonic", 2.0),
            "dna_samplesort": ("dna", dna_log2n, "samplesort", 2.0),
            "dna_overflow": ("dna", dna_log2n, "samplesort",
                             DIST_OVERFLOW_FACTOR),
            "proteins_bitonic": ("proteins", proteins_log2n, "bitonic", 2.0),
            "proteins_samplesort": ("proteins", proteins_log2n,
                                    "samplesort", 2.0)}


def _counts_reset() -> None:
    from repro_torch.core import dist_sort
    from repro_torch.kernels import _build

    _build.reset_launches()
    dist_sort.reset_collectives()


def _counts() -> tuple[dict, dict]:
    from repro_torch.core import dist_sort
    from repro_torch.kernels import _build

    return dict(_build.LAUNCHES), dict(dist_sort.COLLECTIVES)


def mesh_path(toks, pats, mesh, engine: str, cf: float, device) -> dict:
    """One distributed path: ``build_index(tokens, mesh)`` then the
    requests as one count and one locate batch through
    ``SequenceIndex.count`` / ``.locate``, launch and collective counts set
    to 0 before the build and before each batch.  Returns the record with
    the index (``index``) and the answers (``counts``, ``pos``,
    ``cnt``)."""
    import torch

    from repro_torch.core.dist_suffix_array import DistSAConfig
    from repro_torch.core.pipeline import build_index

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _counts_reset()
    t0 = time.perf_counter()
    index = build_index(toks, mesh, sample_rate=64, sa_sample_rate=32,
                        max_retries=DIST_RETRIES, device=device,
                        sa_config=DistSAConfig(engine=engine,
                                               capacity_factor=cf))
    _sync(device)
    rec = {"engine": engine, "capacity_factor": cf, "n": len(toks),
           "build_s": time.perf_counter() - t0,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if cuda else None)}
    rec["launches_build"], rec["collectives_build"] = _counts()
    launches = dict(rec["launches_build"])
    P = pad_patterns(pats, max(len(p) for p in pats), device)
    index.count(P[:8])                     # warm-up: first launches
    index.locate(P[:8], LOCATE_K)
    for kind in ("count", "locate"):
        _counts_reset()
        _sync(device)
        t0 = time.perf_counter()
        out = index.count(P) if kind == "count" else index.locate(
            P, LOCATE_K)
        _sync(device)
        dt = time.perf_counter() - t0
        lc, cc = _counts()
        rec[kind] = {"batch": list(P.shape), "s": dt, "qps": len(pats) / dt,
                     "launches": lc, "collectives": cc}
        for k, v in lc.items():
            launches[k] += v
        if kind == "count":
            rec["counts"] = out
        else:
            rec["pos"], rec["cnt"] = out
    rec["launches"] = launches
    rec["index"] = index
    return rec


def same_dist(rec: dict, sa, bwt, row: int, counts, pos, cnt,
              what: str) -> None:
    """A distributed path's SA, BWT, row and answers equal the
    single-device build's (tensors or numpy, compared on the host)."""
    import numpy as np

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    for name, got, want in (("SA", rec["sa"], sa), ("BWT", rec["bwt"], bwt),
                            ("counts", rec["counts"], counts),
                            ("locate positions", rec["pos"], pos),
                            ("locate counts", rec["cnt"], cnt)):
        require(np.array_equal(host(got), host(want)),
                f"{what}: {name} differ from the single-device build")
    require(int(rec["row"]) == int(row), f"{what}: row differs")


def single_reference(s, sigma: int, pats, device) -> dict:
    """The single-device build of the prepared text ``s`` and its answers
    (the fused query kernels), the reference of a distributed path."""
    from repro_torch.core.pipeline import build_index_prepared

    index = build_index_prepared(s, sigma, sample_rate=64, sa_sample_rate=32,
                                 device=device)
    P = pad_patterns(pats, max(len(p) for p in pats), device)
    pos, cnt = index.locate(P, LOCATE_K)
    return dict(sa=index.sa, bwt=index.bwt, row=int(index.row),
                counts=index.count(P), pos=pos, cnt=cnt)


def snapshot(index, pats) -> dict:
    """Host copies of a main path's build and answers (phase 10's
    reference at one part): SA, BWT, row and the requests' count / locate
    batches through the single-device index."""
    P = pad_patterns(pats, max(len(p) for p in pats), index.sa.device)
    pos, cnt = index.locate(P, LOCATE_K)
    return dict(sa=index.sa.cpu(), bwt=index.bwt.cpu(), row=int(index.row),
                counts=index.count(P).cpu(), pos=pos.cpu(), cnt=cnt.cpu(),
                pats=pats)


def dist_stages(toks, mesh, engine: str, device) -> dict:
    """A second distributed build, stage by stage (each ended by a
    synchronize), with the ISA's rounds."""
    from repro_torch.core.dist_fm import build_dist_fm_index
    from repro_torch.core.dist_suffix_array import (
        DistSAConfig,
        dist_bwt_local,
        dist_isa_local,
        local_text,
    )
    from repro_torch.core.dist_sort import mesh_parts
    from repro_torch.core.pipeline import prepare_tokens

    cfg = DistSAConfig(engine=engine)
    out, stats = {}, {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(device)
        t = time.perf_counter()
        out[name] = t - t0
        t0 = t

    s, sigma = prepare_tokens(toks, mesh_parts(mesh) * 64)
    lap("prepare_tokens_host")
    info, s_local = local_text(s, mesh, device=device)
    lap("host_to_device")
    isa = dist_isa_local(info, cfg, s_local, sigma, stats=stats)
    lap("isa")
    sa, bwt, row = dist_bwt_local(info, cfg, s_local, isa)
    del isa
    lap("bwt")
    build_dist_fm_index(bwt, row, mesh, sigma=sigma, sample_rate=64, sa=sa,
                        sa_sample_rate=32)
    lap("fm_build")
    return {"stages_s": out, "isa_rounds": stats}


def dist_rank_row(index, name: str, lanes: int, seed: int,
                  floor=None, warp=None, stamps=None) -> dict:
    """The single-batch rank kernel of a one-part distributed index (the
    locate walk's ``lanes`` queries over its own layout, as ``dist_fm``'s
    ``_occ_partial`` forms them) against its plain version: ``rank_row``'s
    parity, event and device times, bytes bound and, with ``floor``
    (``rank_floor``), latency floor (with ``warp`` and ``stamps``, the
    pre-redesign unpacked kernel beside it, both stamped)."""
    import torch

    fm = index.fm
    dev = fm.device
    g = torch.Generator(device=dev).manual_seed(seed)
    m, r = fm.bwt.shape[0], fm.sample_rate
    p = torch.randint(0, m + 1, (lanes,), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int32)
    c = torch.randint(1, fm.sigma, (lanes,), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int32)
    blk = torch.clamp(p // r, max=m // r - 1)
    cut = p - blk * r
    if name == "rank_packed":
        args = (fm.fused, blk, c, cut)
        kw = dict(bits=fm.bits, sigma=fm.sigma)
        shape = f"fused[{tuple(fm.fused.shape)}], B={lanes}"
    else:
        blocks = fm.bwt.view(m // r, r)
        args, kw = (blocks, blk, c, cut), {}
        shape = f"blocks[{tuple(blocks.shape)}], sigma={fm.sigma}, B={lanes}"
    row = rank_row(name, args, kw, shape, floor, warp=warp, stamps=stamps)
    check_reading(name, row["device_ms"], row["bound_ms"], row["ms"], shape)
    return row


def _host_answers(counts, pos, cnt) -> dict:
    import numpy as np

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    return {"counts": host(counts), "pos": host(pos), "cnt": host(cnt)}


def check_restored(got: dict, ref: dict, what: str) -> None:
    """A restored index's answers (``_host_answers``) equal the saved
    index's."""
    import numpy as np

    want = _host_answers(ref["counts"], ref["pos"], ref["cnt"])
    for k in ("counts", "pos", "cnt"):
        require(np.array_equal(got[k], want[k]),
                f"{what}: {k} differ from the saved index's")


def require_restore_launches(rec: dict, mesh, cuda: bool, what: str) -> None:
    """On the card a restore that derives its layout launches
    ``char_histogram``, and its queries the rank kernel of its layout (a
    mesh index) or the fused query kernel; on the CPU nothing launches."""
    if not cuda:
        for part in ("launches_restore", "launches_queries"):
            require(set(rec[part].values()) <= {0},
                    f"{what}: a kernel launched on the CPU")
        return
    require(rec["launches_restore"]["char_histogram"] > 0,
            f"{what}: char_histogram never launched by the restore")
    bits = rec["bits"]
    query = (("rank_packed" if bits else "rank_select") if mesh is not None
             else ("fm_query_packed" if bits else "fm_query_unpacked"))
    require(rec["launches_queries"][query] > 0,
            f"{what}: {query} never launched by the restored index")


def restore_path(directory, mesh, pats, device, what: str) -> tuple:
    """One restore of the checkpoint under ``directory`` (onto ``mesh``, or
    one device when None) and the requests as one count and one locate
    batch, launch and collective counts set to 0 before the restore and
    before each batch.  Returns (record, launches of the path, answers on
    the host)."""
    import torch

    from repro_torch.core.index_io import restore_index

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _counts_reset()
    t0 = time.perf_counter()
    index = restore_index(str(directory), mesh, device=device)
    _sync(device)
    rec = {"restore_s": time.perf_counter() - t0, "bits": index.fm.bits,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if cuda else None)}
    rec["launches_restore"], rec["collectives_restore"] = _counts()
    P = pad_patterns(pats, max(len(p) for p in pats), device)
    index.count(P[:8])                     # warm-up: first launches
    index.locate(P[:8], LOCATE_K)
    queries = dict.fromkeys(rec["launches_restore"], 0)
    out = {}
    for kind in ("count", "locate"):
        _counts_reset()
        _sync(device)
        t0 = time.perf_counter()
        out[kind] = index.count(P) if kind == "count" else index.locate(
            P, LOCATE_K)
        _sync(device)
        dt = time.perf_counter() - t0
        lc, cc = _counts()
        rec[kind] = {"s": dt, "qps": len(pats) / dt, "launches": lc,
                     "collectives": cc}
        for k, v in lc.items():
            queries[k] += v
    rec["launches_queries"] = queries
    require_restore_launches(rec, mesh, cuda, what)
    launches = {k: v + queries[k] for k, v in rec["launches_restore"].items()}
    return rec, launches, _host_answers(out["count"], *out["locate"])


def dist_restores(index, toks, pats, ref: dict, mesh, device, build_s: float,
                  fm_ckpt) -> tuple[dict, dict]:
    """Phase 10 (a)'s checkpoints: the one-part mesh ``index`` saved, then
    restored on one device (``mesh=None``) and onto ``mesh``; the
    single-device checkpoint ``fm_ckpt`` (phase 6's of phase 2's build;
    when None, one saved here from a build of ``toks``) restored onto
    ``mesh``.  Each restore answers the requests as ``ref`` (phase 2).
    Returns (record, launches per path)."""
    from repro_torch.core.index_io import save_index
    from repro_torch.core.pipeline import build_index
    from repro_torch.training.checkpoint import Checkpointer

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_ckpt_",
                                dir=build_dir))
    out = {"mesh_build_s": build_s}
    launches = {}
    try:
        saved = tmp / "dist"
        _sync(device)
        t0 = time.perf_counter()
        save_index(str(saved), index)
        _sync(device)
        out["save_s"] = time.perf_counter() - t0
        out["bytes_on_disk"] = dir_bytes(saved)
        t0 = time.perf_counter()
        Checkpointer(str(saved)).restore_raw()
        out["read_npz_s"] = time.perf_counter() - t0   # each restore's read
        if fm_ckpt is None:
            fm_ckpt = tmp / "fm"
            save_index(str(fm_ckpt), build_index(
                toks, sample_rate=64, sa_sample_rate=32, device=device))
        for name, path, where in (("dist_on_one_device", saved, None),
                                  ("dist_on_mesh", saved, mesh),
                                  ("fm_on_mesh", fm_ckpt, mesh)):
            what = f"phase 10 P=1 restore {name}"
            rec, launches[f"dist_restore_{name}"], got = restore_path(
                path, where, pats, device, what)
            check_restored(got, ref, what)
            out[name] = rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches


class LauncherWorld:
    """Phase 10 (c): the serving launcher as a world of 2 ranks through
    ``python -m torch.distributed.run``, built by samplesort and saved,
    then ``--restore``d onto the world; both runs' ``total_hits`` (and
    located positions) must be equal.  ``step`` waits for the run in
    flight and starts the next, so the caller works beside each run;
    ``result`` finishes them; ``close`` stops a run still in flight with
    its ranks and removes the checkpoint."""

    RUNS = (("build", []), ("restore", ["--restore"]))

    def __init__(self, log2n: int, device, timeout_s: float = 600.0):
        build_dir = ROOT / "build"
        build_dir.mkdir(exist_ok=True)
        self.tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_launcher_",
                                         dir=build_dir))
        src = str(ROOT / "src")
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (src, os.environ.get("PYTHONPATH")) if p))
        self.cmd = [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2", "-m",
                    "repro_torch.launch.serve", "--", "--n", str(1 << log2n),
                    "--engine", "samplesort", "--device", str(device),
                    "--ckpt-dir", str(self.tmp / "idx")]
        self.timeout_s = timeout_s
        self.pending = list(self.RUNS)
        self.proc = self.mode = None
        self.t0 = 0.0
        self.out = {}

    def step(self) -> None:
        if self.proc is not None:
            self._wait()
        if self.pending:
            self.mode, extra = self.pending.pop(0)
            self.t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                self.cmd + extra, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=self.env,
                start_new_session=True)

    def _wait(self) -> None:
        proc, mode = self.proc, self.mode
        try:
            text, err = proc.communicate(timeout=self.timeout_s)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 10 launcher {mode}: outlived "
                                 f"{self.timeout_s} s") from None  # close()
        self.proc = None
        require(proc.returncode == 0, f"phase 10 launcher {mode}: exit "
                                      f"{proc.returncode}\n{err[-3000:]}")
        hits = re.findall(r"total_hits=(\d+)", text)
        found = re.findall(r"(\d+) positions", text)
        require(len(hits) == len(found) == 1,
                f"phase 10 launcher {mode}: rank 0 alone prints one "
                f"result, got {hits}, {found}")
        self.out[mode] = {"s": time.perf_counter() - self.t0,
                          "total_hits": int(hits[0]),
                          "located": int(found[0]),
                          "lines": text.strip().splitlines()}

    def result(self) -> dict:
        while self.proc is not None or self.pending:
            self.step()
        b, r = self.out["build"], self.out["restore"]
        require(b["total_hits"] == r["total_hits"] > 0
                and b["located"] == r["located"],
                f"phase 10 launcher: build and restore answer "
                f"differently: {self.out}")
        return self.out

    def close(self) -> None:
        proc = self.proc
        if proc is not None and proc.poll() is None:
            # torch.distributed.run stops its ranks (each in a session of
            # its own) on SIGTERM; whatever is left after a grace period
            # is killed by process id
            ranks = _children(proc.pid)
            proc.terminate()
            try:
                proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
            for pid in ranks:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            proc.communicate()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _children(pid: int) -> list:
    """The process ids under ``pid`` (its children, theirs, ...)."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            kids = [int(k) for k in f.read().split()]
    except OSError:
        return []
    return kids + [g for k in kids for g in _children(k)]


def dist_rank(mesh, spec: dict) -> dict:
    """One rank of a world sharing the card: every build of ``spec``
    through ``mesh_path`` (the overflowing one after a first ISA build
    that shows the overflow), its shards, row and answers; the build
    ``spec["save"]`` names saved to its directory, and the checkpoint
    ``spec["restore"]`` names restored onto the mesh (``restore_path``)."""
    from repro_torch.core import dist_sort
    from repro_torch.core.dist_suffix_array import (
        DistSAConfig,
        build_isa_sharded,
        isa_overflowed,
    )
    from repro_torch.core.index_io import save_index
    from repro_torch.core.pipeline import prepare_tokens
    from repro_torch.data.corpus import corpus

    dev = spec["device"]
    parts = dist_sort.mesh_parts(mesh)
    out = {"transport": dist_sort.transport(
        dist_sort.shard_info(mesh, parts), dev)}
    for name, (kind, log2n, engine, cf) in spec["builds"].items():
        toks = corpus(kind, 1 << log2n)
        pats = sample_patterns(toks, spec["requests"], seed=10)
        first = None
        if cf == DIST_OVERFLOW_FACTOR:
            s, sigma = prepare_tokens(toks, parts * 64)
            isa = build_isa_sharded(s, mesh, DistSAConfig(
                engine=engine, capacity_factor=cf), sigma=sigma, device=dev)
            first = isa_overflowed(isa)
            del isa
        rec = mesh_path(toks, pats, mesh, engine, cf, dev)
        index = rec.pop("index")
        rec.update(sa=index.sa, bwt=index.bwt, row=int(index.row),
                   first_attempt_overflowed=first)
        if spec.get("save", (None,))[0] == name:
            _sync(dev)
            t0 = time.perf_counter()
            save_index(spec["save"][1], index)
            rec["save_s"] = time.perf_counter() - t0
        del index
        out[name] = rec
    if spec.get("restore"):
        name, directory = spec["restore"]
        kind, log2n = spec["builds"][name][:2]
        pats = sample_patterns(corpus(kind, 1 << log2n), spec["requests"],
                               seed=10)
        rec, rec["launches"], rec["answers"] = restore_path(
            directory, mesh, pats, dev,
            f"phase 10 P={parts} restore of {name}")
        out["restore"] = rec
    return out


def nccl_probe_rank(mesh):
    import torch

    from repro_torch.core import dist_sort

    info = dist_sort.shard_info(mesh, mesh.size())
    return dist_sort.psum(info, torch.ones(1, device="cuda"))


def nccl_shared_card() -> str:
    """Whether NCCL takes two ranks on the one card: its answer to a world
    of two ranks on device 0 making one psum."""
    from repro_torch.launch.mesh import run_world

    try:
        run_world(2, nccl_probe_rank, device_type="cuda", timeout_s=120)
    except RuntimeError as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        key = [ln for ln in lines if "uplicate" in ln or "Error" in ln]
        return "refused: " + (key[-1] if key else lines[-1])[:300]
    return "accepted"


def phase_dist(dna_toks, refs: dict, *, dna_log2n: int, proteins_log2n: int,
               small_dna_log2n: int, small_proteins_log2n: int,
               device="cuda", parts=DIST_PARTS, requests: int = 1024,
               rank_fn=None, fm_ckpt=None, launcher_log2n: int = 20,
               chase=None, warp=None, stamps=None):
    """Phase 10.  (a) One NCCL rank (gloo on the CPU) in this process: DNA
    at ``dna_log2n`` (bitonic) and proteins at ``proteins_log2n``, each
    equal to phase 2's / phase 3's build and answers (``refs``, else built
    here), and DNA at ``small_dna_log2n`` by samplesort; the DNA mesh
    index saved and restored on one device and onto the mesh, and the
    single-device checkpoint ``fm_ckpt`` restored onto the mesh
    (``dist_restores``); stage times of a second DNA build; the rank
    kernels on the one-part indexes.  (b) gloo worlds of ``parts`` ranks
    sharing the card (``rank_fn``, default ``dist_rank``): both engines
    at ``small_*_log2n`` and a samplesort from an overflowing factor, each
    equal to the single-device build of the same prepared text and its
    answers; the first world saves its ``DIST_SAVED`` build, the last
    restores it, and so does this process on one device.  (c) the serving
    launcher as a world of 2 at ``launcher_log2n`` (``LauncherWorld``),
    its two runs beside (b)'s worlds.  With ``chase``
    (``start_chase_build``) the rank kernels' rows carry their latency
    floors (``rank_floor``), and with ``warp`` (``stamps``) rank_select's
    row the pre-redesign kernel beside it (both stamped).
    Returns (record, launches per path, the rank kernels' rows)."""
    import torch

    from repro_torch.core import dist_sort
    from repro_torch.core.pipeline import prepare_tokens
    from repro_torch.data.corpus import corpus
    from repro_torch.launch.mesh import single_rank_world

    cuda = torch.device(device).type == "cuda"
    rec, launches, rows = {}, {}, {}
    floor = rank_floor(chase) if chase is not None else None
    small_dna = dna_toks[: 1 << small_dna_log2n]
    one = {"dna": ("dna", dna_toks, "bitonic"),
           "dna_samplesort": ("dna", small_dna, "samplesort"),
           "proteins": ("proteins",
                        corpus("proteins", 1 << proteins_log2n),
                        "bitonic")}
    t_phase = time.perf_counter()
    with single_rank_world("cuda" if cuda else "cpu") as mesh:
        rec["transport_p1"] = dist_sort.transport(
            dist_sort.shard_info(mesh, 1), device)
        for name, (kind, toks, engine) in one.items():
            ref = refs.get(name)
            pats = (ref["pats"] if ref is not None
                    else sample_patterns(toks, requests, seed=10))
            if ref is None:
                s, sigma = prepare_tokens(toks, 64)
                ref = single_reference(s, sigma, pats, device)
            r = mesh_path(toks, pats, mesh, engine, 2.0, device)
            index = r.pop("index")
            r.update(sa=index.sa, bwt=index.bwt, row=int(index.row))
            same_dist(r, ref["sa"], ref["bwt"], ref["row"], ref["counts"],
                      ref["pos"], ref["cnt"], f"phase 10 P=1 {name}")
            for k in ("sa", "bwt", "counts", "pos", "cnt"):
                del r[k]
            launches[f"dist_p1_{name}"] = r.pop("launches")
            require_dist_launches(launches[f"dist_p1_{name}"], kind, cuda,
                                  f"phase 10 P=1 {name}")
            if name == "dna":
                rec["p1_restore"], restored = dist_restores(
                    index, toks, pats, ref, mesh, device, r["build_s"],
                    fm_ckpt)
                launches.update(restored)
            if cuda and name in ("dna", "proteins"):
                kname = "rank_packed" if index.fm.bits else "rank_select"
                rows[kname] = dist_rank_row(index, kname,
                                            requests * LOCATE_K, seed=10,
                                            floor=floor, warp=warp,
                                            stamps=stamps)
            del index, ref
            refs.pop(name, None)
            if cuda:
                torch.cuda.empty_cache()
            if name == "dna":
                r.update(dist_stages(toks, mesh, engine, device))
            rec[f"p1_{name}"] = r
    rec["p1_s"] = time.perf_counter() - t_phase

    spec = {"device": device, "requests": requests,
            "builds": dist_builds(small_dna_log2n, small_proteins_log2n)}
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    saved = Path(tempfile.mkdtemp(prefix="chip_smoke_world_ckpt_",
                                  dir=build_dir)) / "index"
    # (c) runs beside (b): its build beside the first world, its restore
    # beside the next (ranks on the host CPU and the card, time-shared)
    launcher = LauncherWorld(launcher_log2n, device)
    t0 = time.perf_counter()
    try:
        rec.update(dist_worlds(spec, parts, saved, device, rank_fn,
                               launches, beside=launcher.step))
        rec["launcher"] = launcher.result()
    finally:
        launcher.close()
        shutil.rmtree(saved.parent, ignore_errors=True)
    rec["worlds_and_launcher_s"] = time.perf_counter() - t0
    if cuda:
        rec["nccl_two_ranks_one_card"] = nccl_shared_card()
    rec["rank_kernels"] = rows
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, launches, rows


def dist_worlds(spec: dict, parts, saved: Path, device, rank_fn,
                launches: dict, beside=None) -> dict:
    """Phase 10 (b): a world of each of ``parts`` ranks through
    ``rank_fn``, every build equal to the single-device build of its text
    on every rank; the first world saves its ``DIST_SAVED`` build under
    ``saved``, the last restores it onto its mesh and this process on one
    device, each answering as the saved index.  ``beside()`` is called
    before each world starts.  Adds each path's launches (summed over the
    ranks) to ``launches``; returns the record."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import prepare_tokens
    from repro_torch.data.corpus import corpus
    from repro_torch.launch.mesh import run_world

    cuda = torch.device(device).type == "cuda"
    rec, saved_ref = {}, None
    for i, P in enumerate(parts):
        spec_p = dict(spec)
        if i == 0:
            spec_p["save"] = (DIST_SAVED, str(saved))
        if i == len(parts) - 1:
            spec_p["restore"] = (DIST_SAVED, str(saved))
        if beside is not None:
            beside()
        t0 = time.perf_counter()
        ranks = run_world(P, rank_fn or dist_rank, spec_p,
                          timeout_s=DIST_WORLD_TIMEOUT_S)
        world = {"transport": ranks[0]["transport"],
                 "world_s": time.perf_counter() - t0}
        for name, (kind, log2n, engine, cf) in spec["builds"].items():
            toks = corpus(kind, 1 << log2n)
            pats = sample_patterns(toks, spec["requests"], seed=10)
            s, sigma = prepare_tokens(toks, P * 64)
            ref = single_reference(s, sigma, pats, device)
            got = dict(ranks[0][name])
            got["sa"] = np.concatenate([r[name]["sa"] for r in ranks])
            got["bwt"] = np.concatenate([r[name]["bwt"] for r in ranks])
            for r in ranks:
                got.update(row=r[name]["row"], counts=r[name]["counts"],
                           pos=r[name]["pos"], cnt=r[name]["cnt"])
                same_dist(got, ref["sa"], ref["bwt"], ref["row"],
                          ref["counts"], ref["pos"], ref["cnt"],
                          f"phase 10 P={P} {name}")
            if cf == DIST_OVERFLOW_FACTOR:
                require(all(r[name]["first_attempt_overflowed"]
                            for r in ranks),
                        f"phase 10 P={P} {name}: capacity factor {cf} did "
                        f"not overflow, so no retry ran")
            total = {k: sum(r[name]["launches"][k] for r in ranks)
                     for k in ranks[0][name]["launches"]}
            require_dist_launches(total, kind, cuda, f"phase 10 P={P} {name}")
            launches[f"dist_p{P}_{name}"] = total
            world[name] = {k: v for k, v in got.items()
                           if k not in ("sa", "bwt", "counts", "pos", "cnt",
                                        "launches")}
            world[name]["launches_all_ranks"] = total
            if i == 0 and name == DIST_SAVED:
                saved_ref = _host_answers(ref["counts"], ref["pos"],
                                          ref["cnt"])
            del ref
        if "restore" in spec_p:
            for r in ranks:
                check_restored(r["restore"].pop("answers"), saved_ref,
                               f"phase 10 P={P} restore of {DIST_SAVED}")
            total = {k: sum(r["restore"]["launches"][k] for r in ranks)
                     for k in ranks[0]["restore"]["launches"]}
            launches[f"dist_p{P}_restore"] = total
            world["restore"] = {k: v for k, v in ranks[0]["restore"].items()
                                if k != "launches"}
            world["restore"]["launches_all_ranks"] = total
        rec[f"p{P}"] = world
    kind, log2n = spec["builds"][DIST_SAVED][:2]
    pats = sample_patterns(corpus(kind, 1 << log2n), spec["requests"],
                           seed=10)
    what = f"phase 10 restore of the P={parts[0]} {DIST_SAVED} on one device"
    rec["restore_one_device"], launches["dist_restore_one_device"], got = (
        restore_path(saved, None, pats, device, what))
    check_restored(got, saved_ref, what)
    return rec


# --------------------------------------------------------------------------
# phase 11: LM serving (models/*, serving/engine.generate)
# --------------------------------------------------------------------------

LM_TOL = 1e-4            # float32, card against CPU: |a - b| <= tol (1 + |b|)
LM_MOE_TOL = 1e-3        # MoE: index_add_'s order on CUDA is not fixed
LM_STEP_TOL = 1e-5       # a train step's metrics and updated state
LM_BF16_TOL = 0.05       # bf16 decode against forward: of the max |logit|
LM_REDUCED_LONG = ("qwen2p5_3b", "minicpm3_4b")   # GQA and MLA at S = 2048
LM_PROMPT, LM_NEW, LM_DECODE = 4, 8, 8


def on_device(params, device):
    """The CPU-made weights carried to ``device``."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.to(device), params)


def max_err(a, b) -> float:
    return float((a.detach().float().cpu() - b.detach().float().cpu())
                 .abs().max())


def require_close(a, b, tol: float, what: str) -> float:
    """|a - b| <= tol * (1 + |b|) everywhere (``b`` the CPU's); returns
    max |a - b|."""
    import torch

    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    require(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} != "
                                f"{tuple(b.shape)}")
    require(bool(torch.isfinite(a).all()), f"{what}: non-finite values")
    ok = bool(((a - b).abs() <= tol * (1 + b.abs())).all())
    err = max_err(a, b)
    require(ok, f"{what}: card differs from the CPU (max err {err}, "
                f"tol {tol})")
    return err


def lm_batch(cfg, B: int, S: int, device, seed: int = 0) -> dict:
    """Tokens, or embeddings for the frontend stubs, from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if cfg.frontend != "none":
        e = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
        return {"embeds": torch.from_numpy(e).to(device)}
    t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": torch.from_numpy(t).to(device)}


def lm_decode(params, cfg, tokens, dtype, ctx=None) -> "torch.Tensor":
    """Decode logits (B, T, V) along ``tokens`` (B, T) from a fresh cache
    (the params' device and ``dtype``); in a world (``ctx``) the cache is
    the rank's and the logits are put together from the ranks' blocks."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.sharding import gather_global, single_device_context

    ctx = ctx or single_device_context()
    B, T = tokens.shape
    cache = tf.init_cache(cfg, B, T, dtype, tokens.device, ctx)
    out = []
    for pos in range(T):
        logits, cache = tf.decode_step(params, cache, tokens[:, pos:pos + 1],
                                       pos, cfg, ctx)
        out.append(gather_global(logits, ctx, ("batch", "act_model"),
                                 (B, cfg.vocab_size)))
    return torch.stack(out, 1)


def tokens_agree(got, want, want_logits, prompt: int, tol: float,
                 what: str) -> int:
    """Generated tokens equal the CPU's, or each row differs first where
    the CPU's top-2 logits (``want_logits`` (B, T-1, V) along ``want``)
    lie within ``tol``; returns the rows that differ."""
    import numpy as np

    require(np.array_equal(got[:, :prompt], want[:, :prompt]),
            f"{what}: prompt changed")
    rows = 0
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            top2 = np.sort(want_logits[b, diff[0] - 1].float().numpy())[-2:]
            require(top2[1] - top2[0] <= tol * (1 + abs(top2[1])),
                    f"{what}: row {b} differs at {diff[0]} where the CPU's "
                    f"top-2 logits are {top2}")
            rows += 1
    return rows


def lm_reduced(arch: str, device, long_s: bool) -> dict:
    """One reduced config in float32 on ``device`` against the CPU, on the
    same weights (made on the CPU from a seeded generator, carried over):
    forward at B = 2, S = 16 (and S = 2048 when ``long_s``), 8 decode
    steps, generate with 8 new tokens."""
    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import generate
    from repro_torch.sharding import single_device_context

    cfg = get_reduced_config(arch)
    tol = LM_MOE_TOL if cfg.num_experts else LM_TOL
    ctx = single_device_context()
    cpu = tf.init_model(cfg, torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    dev = on_device(cpu, device)
    rec = {"tol": tol}
    lengths = (16, 2048) if long_s else (16,)
    with torch.no_grad():
        for S in lengths:
            batch = lm_batch(cfg, 2, S, "cpu", seed=S)
            want = tf.forward(cpu, batch, cfg, ctx)
            got = tf.forward(dev, {k: v.to(device) for k, v in batch.items()},
                             cfg, ctx)
            rec[f"forward_S{S}_err"] = require_close(
                got, want, tol, f"phase 11 {arch} forward S={S}")
        toks = lm_batch(cfg.replace(frontend="none"), 2, LM_DECODE, "cpu",
                        seed=1)["tokens"]
        want = lm_decode(cpu, cfg, toks, torch.float32)
        got = lm_decode(dev, cfg, toks.to(device), torch.float32)
        rec["decode_err"] = require_close(got, want, tol,
                                          f"phase 11 {arch} decode")
        prompts = toks[:, :LM_PROMPT].numpy()
        want = generate(cpu, cfg, ctx, prompts, LM_NEW).tokens
        res = generate(dev, cfg, ctx, prompts, LM_NEW)
        want_logits = lm_decode(cpu, cfg, torch.from_numpy(want[:, :-1]),
                                torch.float32)
        rec["generate_rows_differ"] = tokens_agree(
            res.tokens, want, want_logits, LM_PROMPT, tol,
            f"phase 11 {arch} generate")
        rec["generate_tokens_per_s"] = res.tokens_per_s
    return rec


# the full-width parts: (name, config id, depth cut, generate (B, prompt,
# new), forward (B, S), decode-against-forward positions)
LM_FULL = (
    ("minitron_4b", "minitron_4b", None, (8, 64, 64), (1, 2048), 16),
    ("mamba2_1p3b", "mamba2_1p3b", None, (8, 64, 64), (1, 2048), 0),
    ("deepseek_v2_236b", "deepseek_v2_236b", 3, (8, 16, 16), (4, 1024), 0),
)


class DeviceMemory:
    """Allocated and peak bytes on a CUDA device (zeros on the CPU, where
    the phase is rehearsed)."""

    def __init__(self, device):
        import torch

        self.cuda = torch.cuda if torch.device(device).type == "cuda" else None

    def reset_peak(self) -> None:
        if self.cuda:
            self.cuda.empty_cache()
            self.cuda.reset_peak_memory_stats()

    def allocated_gib(self) -> float:
        return self.cuda.memory_allocated() / 2**30 if self.cuda else 0.0

    def peak_gib(self) -> float:
        return self.cuda.max_memory_allocated() / 2**30 if self.cuda else 0.0


def decode_profile(params, cfg, prompts, device, steps: int = 4) -> dict:
    """``steps`` decode steps over the prompts' first tokens, timed alone
    and then under torch.profiler: ms a step, the device's busy share,
    device launches a step and the top device rows."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.sharding import single_device_context

    ctx = single_device_context()
    toks = torch.from_numpy(prompts[:, :steps]).to(device)
    cache = tf.init_cache(cfg, toks.shape[0], steps, torch.bfloat16, device)

    def run():
        for pos in range(steps):
            tf.decode_step(params, cache, toks[:, pos:pos + 1], pos, cfg, ctx)

    run()                                        # warm
    _, wall = timed(run, device)
    prof = profiled(run)
    return {"steps": steps, "ms_per_step": 1e3 * wall / steps,
            "device_ms_per_step": 1e3 * prof["device_s"] / steps,
            "device_busy_share": prof["device_busy_share"],
            "launches_per_step": prof["device_launches"] / steps,
            "top": prof["top"][:6]}


def lm_full(name: str, arch: str, layers, gen, fwd, check: int,
            device) -> dict:
    """A config at full width (depth cut to ``layers`` when given) in bf16
    with weights drawn on ``device`` from a seeded generator: generate
    (tokens/s, ms a decode step, peak memory), forward(last_token_only)
    timed, and decode against forward on the first ``check`` positions."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import generate
    from repro_torch.sharding import single_device_context

    full = get_config(arch)
    cfg = full if layers is None else full.replace(num_layers=layers)
    ctx = single_device_context()
    mem = DeviceMemory(device)
    mem.reset_peak()
    base = mem.allocated_gib()
    params, init_s = timed(lambda: tf.init_model(
        cfg, torch.Generator(device).manual_seed(0), torch.bfloat16, device),
        device)
    rec = {"params": tf.count_params(cfg),
           "weights_gib": mem.allocated_gib() - base, "init_s": init_s}
    if layers is not None:
        rec["reduced"] = {"num_layers": [full.num_layers, layers]}
    B, prompt, new = gen
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)
    with torch.no_grad():
        generate(params, cfg, ctx, prompts[:, :4], 2,
                 dtype=torch.bfloat16)                       # warm-up
        mem.reset_peak()
        res = generate(params, cfg, ctx, prompts, new, dtype=torch.bfloat16)
        rec["generate"] = {
            "batch": B, "prompt": prompt, "new": new,
            "tokens_per_s": res.tokens_per_s,
            "ms_per_step": 1e3 * B / res.tokens_per_s,
            "steps": prompt + new - 1, "peak_gib": mem.peak_gib()}
        require(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size))
                     .all()), f"phase 11 {name}: token out of the vocabulary")
        if mem.cuda:
            rec["decode_profile"] = decode_profile(params, cfg, prompts,
                                                   device)
        fb, fs = fwd
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (fb, fs)).astype(np.int32)).to(device)}
        mem.reset_peak()
        logits, first_s = timed(lambda: tf.forward(
            params, batch, cfg, ctx, last_token_only=True), device)
        logits, warm_s = timed(lambda: tf.forward(
            params, batch, cfg, ctx, last_token_only=True), device)
        require(logits.shape == (fb, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits.float()).all()),
                f"phase 11 {name}: forward logits {tuple(logits.shape)} "
                f"not finite or of the wrong shape")
        rec["forward"] = {"batch": fb, "seq": fs, "first_s": first_s,
                          "s": warm_s, "peak_gib": mem.peak_gib()}
        if cfg.num_experts:
            from repro_torch.models.blocks import capacity

            rec["forward"]["capacity"] = capacity(cfg, fb * fs)
        if check:
            toks = torch.from_numpy(prompts[:, :check]).to(device)
            f = tf.forward(params, {"tokens": toks}, cfg, ctx).float()
            d = lm_decode(params, cfg, toks, torch.bfloat16).float()
            err = float((d - f).abs().max())
            scale = float(f.abs().max())
            require(bool(torch.isfinite(d).all())
                    and err <= LM_BF16_TOL * scale,
                    f"phase 11 {name}: decode differs from forward by {err} "
                    f"(max |logit| {scale}, tol {LM_BF16_TOL} of it)")
            rec["decode_vs_forward"] = {
                "positions": check, "max_err": err, "max_abs_logit": scale,
                "argmax_agree": float((d.argmax(-1) == f.argmax(-1))
                                      .float().mean())}
    del params
    mem.reset_peak()
    return rec


def phase_lm(device="cuda", archs=None, full: bool = True) -> tuple:
    """Phase 11: (a) each reduced config (``archs``: all ten) on ``device``
    against the CPU; (b)-(d) the full-width parts when ``full``.  Returns
    (record, launches over the phase): it launches no kernel of the
    index."""
    from repro_torch.configs.base import ARCH_IDS

    archs = archs or [a for a in ARCH_IDS if a != "bwt_index"]
    _counts_reset()
    t0 = time.perf_counter()
    rec = {"reduced_configs": {
        a: lm_reduced(a, device, a in LM_REDUCED_LONG) for a in archs}}
    rec["reduced_s"] = time.perf_counter() - t0
    if full:
        for spec in LM_FULL:
            t1 = time.perf_counter()
            rec[spec[0]] = lm_full(*spec, device)
            rec[spec[0]]["part_s"] = time.perf_counter() - t1
    launches, _ = _counts()
    require(sum(launches.values()) == 0,
            f"phase 11 launched index kernels: {launches}")
    rec["phase_s"] = time.perf_counter() - t0
    return rec, launches


# --------------------------------------------------------------------------
# phase 12: LM training
# --------------------------------------------------------------------------

# test_checkpoint.py's bitwise-resume optimizer; the reduced steps' batch
TRAIN_ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=12)
TRAIN_B, TRAIN_S = 2, 16
REMAT = ("full", "dots", "none")
FP32_PEAK_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
# the repeated-step probes of (b): reduced configs and their changes (the
# full deepseek_v2_236b routes each token to 6 experts, the reduced to 2)
TRAIN_REPEAT = (("qwen2p5_3b", {}), ("deepseek_v2_236b", {}),
                ("deepseek_v2_236b", {"top_k": 6}))
# the full-width parts: (config id, batch, seq, steps, compress_grads, a
# "dots" step); qwen2p5_3b's steps cut from 6 to 4 to pay for phase 15
TRAIN_FULL = (("qwen2p5_3b", 2, 1024, 4, False, True),
              ("mamba2_1p3b", 2, 2048, 3, True, False))
# the screen: the english corpus at 2^22 tokens with a copy of its first
# 2^18 planted at its end (the corpus has no repeated 64-token window of
# its own), examples/train_lm.py's window, stride and sample rate
TRAIN_SCREEN = dict(log2n=22, plant_log2n=18, window=64, stride=256,
                    sample_rate=64)


@contextlib.contextmanager
def algorithms(deterministic: bool):
    """``torch.use_deterministic_algorithms(deterministic)`` for the block,
    the earlier setting back after it (main sets the cuBLAS workspace the
    deterministic mode needs before any CUDA work)."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def copy_to(tree, device):
    """A copy of a tensor tree on ``device`` (a copy on its own device
    too: the train step writes its state in place)."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.to(device, copy=True), tree)


def state_leaves(state) -> list:
    """(name, tensor) of a train state's params, m and v."""
    from repro_torch.models.common import tree_leaves

    return [(f"{part}[{i}]", t)
            for part, tree in (("params", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"]))
            for i, t in enumerate(tree_leaves(tree))]


def train_parity(arch: str, device) -> dict:
    """One make_train_step of a reduced config on ``device`` against the
    CPU from the same float32 state (made on the CPU from a seeded
    generator, carried over): loss, grad_norm, lr and every updated leaf
    of params / m / v under remat "full"; the loss (and the state) under
    "dots" and "none", with deterministic algorithms, as ``train`` runs."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.corpus import corpus
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.sharding import single_device_context
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    cfg = get_reduced_config(arch)
    tol = LM_MOE_TOL if cfg.num_experts else LM_TOL
    ctx = single_device_context()
    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_ADAMW))
    init = init_train_state(cfg, torch.Generator().manual_seed(0), tcfg,
                            torch.float32, "cpu")
    toks = corpus("english", 1 << 12) % (cfg.vocab_size - 1) + 1
    batch = {k: torch.from_numpy(v) for k, v in TokenLoader(
        toks, LoaderConfig(TRAIN_B, TRAIN_S, seed=3)).batch(0).items()}
    want_state, want = make_train_step(cfg, ctx, tcfg)(copy_to(init, "cpu"),
                                                       batch)
    rec = {"tol": tol}
    on_card = {}
    for policy in REMAT:
        step = make_train_step(cfg, ctx, dataclasses.replace(
            tcfg, remat_policy=policy))
        with algorithms(True):
            state, got = step(copy_to(init, device),
                              {k: v.to(device) for k, v in batch.items()})
        on_card[policy] = state
        rec[f"loss_err_{policy}"] = require_close(
            got["loss"], want["loss"], tol,
            f"phase 12 {arch} loss (remat {policy})")
        if policy != "full":
            continue
        for k in ("grad_norm", "lr"):
            rec[f"{k}_err"] = require_close(got[k], want[k], tol,
                                            f"phase 12 {arch} {k}")
        rec["state_err"] = max(
            require_close(a, b, tol, f"phase 12 {arch} {name}")
            for (name, a), (_, b) in zip(state_leaves(state),
                                         state_leaves(want_state)))
    rec["remat_states_equal"] = all(
        all(torch.equal(a, b) for (_, a), (_, b) in zip(
            state_leaves(on_card["full"]), state_leaves(on_card[p])))
        for p in REMAT[1:])
    return rec


def resume_run(arch: str, device, workdir) -> dict:
    """test_bitwise_resume's scenario on ``device``: 12 steps, and 6 steps
    resumed to 12 from their checkpoint; whether the resumed losses equal
    the uninterrupted run's bit for bit, and the steps' seconds."""
    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.corpus import corpus
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.sharding import single_device_context
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, train

    cfg = get_reduced_config(arch).replace(vocab_size=128)
    loader = TokenLoader(corpus("english", 8000) % 128,
                         LoaderConfig(2, 16, seed=3))
    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_ADAMW), checkpoint_every=3,
                       log_every=0)
    ctx = single_device_context()
    tag = arch
    run = dict(seed=7, log=lambda *_: None, device=device)
    full, full_s = timed(lambda: train(
        cfg, ctx, tcfg, loader, 12, ckpt_dir=str(workdir / f"{tag}_a"),
        **run), device)
    part = train(cfg, ctx, tcfg, loader, 6,
                 ckpt_dir=str(workdir / f"{tag}_b"), **run)
    resumed = train(cfg, ctx, tcfg, loader, 12,
                    ckpt_dir=str(workdir / f"{tag}_b"), resume=True, **run)
    want = torch.tensor(full["losses"])
    got = torch.tensor(part["losses"] + resumed["losses"])
    return {"bitwise": bool(torch.equal(got, want)),
            "max_loss_diff": float((got - want).abs().max()),
            "losses": full["losses"], "s_per_step": full_s / 12}


def matmul_params(spec_tree) -> int:
    """Params of the weight matrices in a spec tree: the drawn leaves
    ("normal" / "small") but the embedding table (a gather) and the
    depthwise conv taps; norms, biases and the SSM scalars are not."""
    import numpy as np

    if isinstance(spec_tree, dict):
        return sum(matmul_params(v) for k, v in spec_tree.items()
                   if k not in ("embed", "conv_w"))
    if isinstance(spec_tree, list):
        return sum(matmul_params(v) for v in spec_tree)
    return (int(np.prod(spec_tree.shape))
            if spec_tree.init in ("normal", "small") else 0)


def repeat_step(arch: str, device, deterministic: bool, batch: int = 8,
                seq: int = 256, **replace) -> dict:
    """One make_train_step of a reduced config (fields ``replace``d) run
    twice from the same state on ``device``, with deterministic algorithms
    on or off: whether the two updated states are equal bit for bit, and
    the largest difference."""
    import torch

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.corpus import corpus
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.sharding import single_device_context
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    cfg = get_reduced_config(arch).replace(**replace)
    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_ADAMW))
    init = init_train_state(cfg, torch.Generator().manual_seed(0), tcfg,
                            torch.float32, "cpu")
    toks = corpus("english", 1 << 16) % (cfg.vocab_size - 1) + 1
    data = {k: torch.from_numpy(v).to(device) for k, v in TokenLoader(
        toks, LoaderConfig(batch, seq, seed=5)).batch(0).items()}
    step = make_train_step(cfg, single_device_context(), tcfg)
    with algorithms(deterministic):
        a, b = (step(copy_to(init, device), data)[0] for _ in range(2))
    diffs = [float((x - y).abs().max()) for (_, x), (_, y) in zip(
        state_leaves(a), state_leaves(b))]
    return {"bitwise": max(diffs) == 0, "max_diff": max(diffs),
            "tokens": batch * seq}


def train_flops(cfg, batch: int, seq: int) -> int:
    """Matmul operations of one training step under remat "full" (dense
    or SSM configs): 6 N T over the weight matrices; the stacked groups'
    forward again, but for each group's last product, whose output the
    backward does not need (the recompute stops before it); and the
    sequence mixer's own products at four times their forward (the
    forward, twice that in the backward, the recompute): attention's two
    S x S products as the port computes them (the whole square, masked
    after), or the SSD chunks' four contractions."""
    from repro_torch.models import transformer as tf

    require(cfg.num_experts == 0, "train_flops counts dense and SSM configs")
    specs = tf.model_specs(cfg)
    last = specs["blocks"][f"s{len(tf.layer_pattern(cfg)) - 1}"]
    last = last["mixer"]["out_proj"] if cfg.family == "ssm" else \
        last["ffn"]["w_down"]
    T = batch * seq
    if cfg.family == "ssm":
        b, l, h = batch, cfg.ssd_chunk, cfg.d_inner // cfg.ssm_headdim
        c, n, p = seq // l, cfg.ssm_state, cfg.ssm_headdim
        mixer = 2 * b * c * h * l * l * (n + p) + 4 * b * c * l * h * n * p
    else:
        mixer = 4 * batch * cfg.num_heads * seq * seq * cfg.head_dim
    recompute = matmul_params(specs["blocks"]) - matmul_params(last)
    return (6 * matmul_params(specs) * T + 2 * recompute * T
            + 4 * cfg.num_layers * mixer)


def screen(toks, device, window: int, stride: int,
           sample_rate: int) -> tuple:
    """examples/train_lm.py's dedup stage over all of ``toks``: the index
    built on ``device``, duplicate_window_mask; (mask, record, launches)."""
    from repro_torch.data.dedup import (
        build_corpus_index,
        duplicate_window_mask,
    )

    _counts_reset()
    t0 = time.perf_counter()
    index, build_s = timed(lambda: build_corpus_index(
        toks, device=device, sample_rate=sample_rate), device)
    mask = duplicate_window_mask(index, toks, window=window, stride=stride)
    _sync(device)
    dedup_s = time.perf_counter() - t0
    launches, _ = _counts()
    del index
    return mask, {"tokens": len(toks), "window": window, "stride": stride,
                  "windows": len(range(0, len(toks) - window, stride)),
                  "build_s": build_s, "dedup_s": dedup_s,
                  "drop_share": float(mask.mean()),
                  "dropped_tokens": int(mask.sum())}, launches


def train_full(arch: str, cfg, raw, screened, mask, batch: int, seq: int,
               steps: int, compress: bool, dots: bool, device) -> dict:
    """``steps`` steps of ``cfg`` through ``train`` (remat "full", no
    checkpoint) on the screened stream (``screened``, the corpus ``raw``
    mapped into the vocabulary, with its dedup ``mask``): s a step,
    tokens/s and peak memory beside the float32 bound; then one profiled
    step, two steps with deterministic algorithms off against two with
    them on (in turns), and with ``dots`` two steps under remat "dots",
    their peak and a profiled third."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import single_device_context
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (
        TrainConfig,
        make_train_step,
        train,
    )

    ctx = single_device_context()
    require(bool(np.array_equal(raw % (cfg.vocab_size - 1) + 1, screened)),
            f"phase 12 {arch}: the token map differs from the screened one")
    loader = TokenLoader(screened, LoaderConfig(batch, seq, seed=0),
                         drop_mask=mask)
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                       total_steps=steps),
                       remat_policy="full", compress_grads=compress,
                       checkpoint_every=0, log_every=1)
    mem = DeviceMemory(device)
    mem.reset_peak()
    stamps = []
    t0 = time.perf_counter()
    res = train(cfg, ctx, tcfg, loader, steps, seed=0, device=device,
                log=lambda line: stamps.append(time.perf_counter()))
    losses = res["losses"]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"phase 12 {arch}: losses {losses}")
    step_s = list(np.diff(stamps))
    s = float(np.median(step_s))
    flop = train_flops(cfg, batch, seq)
    rec = {"params": tf.count_params(cfg), "batch": batch, "seq": seq,
           "steps": steps, "compress_grads": compress, "losses": losses,
           "init_and_first_step_s": stamps[0] - t0, "step_s": step_s,
           "s_per_step": s, "tokens_per_s": batch * seq / s,
           "peak_gib": mem.peak_gib(), "flop_per_step": flop,
           "bound_s": flop / FP32_PEAK_FLOPS,
           "bound_share": flop / FP32_PEAK_FLOPS / s}
    state = res["state"]
    del res
    step = make_train_step(cfg, ctx, tcfg)
    data = {k: torch.as_tensor(v, device=device)
            for k, v in loader.batch(steps).items()}
    if mem.cuda:
        with algorithms(True):
            prof = profiled(lambda: step(state, data))
        rec["profile"] = {k: prof[k] for k in ("wall_s", "device_s",
                                               "device_busy_share",
                                               "device_launches", "top")}
    turns = {"deterministic": [], "nondeterministic": []}
    for name in ("deterministic", "nondeterministic", "nondeterministic",
                 "deterministic"):
        with algorithms(name == "deterministic"):
            _, sec = timed(lambda: step(state, data), device)
        turns[name].append(sec)
    rec["determinism_s"] = turns
    if dots:
        step = make_train_step(cfg, ctx, dataclasses.replace(
            tcfg, remat_policy="dots"))
        mem.reset_peak()
        with algorithms(True):
            secs = [timed(lambda: step(state, data), device)[1]
                    for _ in range(2)]
        rec["dots"] = {"step_s": secs, "peak_gib": mem.peak_gib()}
        if mem.cuda:
            with algorithms(True):
                prof = profiled(lambda: step(state, data))
            rec["dots"]["profile"] = {k: prof[k] for k in (
                "wall_s", "device_s", "device_busy_share",
                "device_launches")}
    rec["steps_taken"] = int(state["opt"]["count"])
    del state
    mem.reset_peak()
    return rec


def launcher_resume(device, steps: int = 10, cut: int = 6) -> dict:
    """``python -m repro_torch.launch.train --arch qwen2p5_3b --steps 10
    --ckpt-dir <a>`` (reduced), then the same with ``--resume`` and a
    directory that holds only <a>'s step-``cut`` checkpoint (as a run
    stopped after that step leaves it): the resumed run continues from
    ``cut``, prints the same final loss, and its step-10 checkpoint holds
    <a>'s arrays bit for bit."""
    import numpy as np

    from repro_torch.training.checkpoint import Checkpointer

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_",
                                 dir=ROOT / "build"))
    dirs = {"first": work / "first", "resume": work / "resume"}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    rec = {}
    try:
        for name, extra in (("first", []), ("resume", ["--resume"])):
            if name == "resume":
                step_dir = f"step_{cut:08d}"
                shutil.copytree(dirs["first"] / step_dir,
                                dirs["resume"] / step_dir)
            argv = [sys.executable, "-m", "repro_torch.launch.train",
                    "--arch", "qwen2p5_3b", "--steps", str(steps),
                    "--ckpt-dir", str(dirs[name]), "--device", str(device),
                    *extra]
            t0 = time.perf_counter()
            out = subprocess.run(argv, capture_output=True, text=True,
                                 env=env, cwd=ROOT, timeout=600)
            require(out.returncode == 0, f"phase 12 launcher {name}: exit "
                    f"{out.returncode}: {out.stderr[-2000:]}")
            lines = out.stdout.splitlines()
            final = [ln for ln in lines if ln.startswith("final loss ")]
            require(len(final) == 1, f"phase 12 launcher {name}: "
                    f"{out.stdout[-2000:]}")
            rec[name] = {"final": final[0], "s": time.perf_counter() - t0,
                         "resumed": [ln for ln in lines
                                     if ln.startswith("resumed at step")]}
        require(rec["resume"]["resumed"] == [f"resumed at step {cut}"],
                f"phase 12 launcher: {rec['resume']['resumed']}")
        a, b = (Checkpointer(str(d)).restore_raw(steps)[0]
                for d in dirs.values())
        rec["final_arrays_equal"] = a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(rec["first"]["final"] == rec["resume"]["final"],
            f"phase 12 launcher: {rec['first']['final']} then "
            f"{rec['resume']['final']} after --resume")
    require(rec["final_arrays_equal"], "phase 12 launcher: the resumed "
            "run's step-10 state differs from the uninterrupted run's")
    return rec


def phase_train(device="cuda", archs=None, full=True,
                resume_archs=("qwen2p5_3b", "deepseek_v2_236b"),
                repeat_probes=TRAIN_REPEAT, full_parts=TRAIN_FULL,
                screen_args=TRAIN_SCREEN, config_of=None,
                launcher=True) -> tuple:
    """Phase 12: (a) each reduced config's train step on ``device``
    against the CPU (``archs``: all ten), (b) bitwise resume, (c) the
    dedup-screened full-width run, (d) the compressed full-width SSM run
    (``full_parts``, configs from ``config_of``: ``get_config``), (e) the
    launcher's --resume.  Returns (record, launches by path): the
    screen's index kernels, none in training."""
    import torch

    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.data.corpus import corpus

    archs = archs or [a for a in ARCH_IDS if a != "bwt_index"]
    config_of = config_of or get_config
    precision = torch.get_float32_matmul_precision()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rec = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    launches = {}
    try:
        _counts_reset()
        rec["reduced_configs"] = {a: train_parity(a, device) for a in archs}
        (ROOT / "build").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_",
                                     dir=ROOT / "build"))
        try:
            rec["resume"] = {}
            for arch in resume_archs:
                run = resume_run(arch, device, work)
                require(run["bitwise"], f"phase 12 {arch}: the resumed "
                        f"losses differ from the uninterrupted run by "
                        f"{run['max_loss_diff']}")
                rec["resume"][arch] = run
            # a step repeated from one state at 2048 tokens: the MoE
            # dispatch adds top_k slots into each token, and three or more
            # addends make the order of index_add_'s atomics show
            rec["repeat"] = {}
            for arch, extra in repeat_probes:
                name = "_".join([arch, *(f"{k}{v}" for k, v in extra.items())])
                runs = {det: repeat_step(arch, device, det, **extra)
                        for det in (True, False)}
                require(runs[True]["bitwise"], f"phase 12 {name}: a repeated "
                        f"step differs by {runs[True]['max_diff']}")
                rec["repeat"][name] = {"deterministic": runs[True],
                                       "nondeterministic": runs[False]}
        finally:
            shutil.rmtree(work, ignore_errors=True)
        launches["lm_training"], _ = _counts()
        rec["reduced_s"] = time.perf_counter() - t0
        if full:
            raw = corpus("english", 1 << screen_args["log2n"])
            plant = 1 << screen_args["plant_log2n"]
            raw[-plant:] = raw[:plant]
            first = config_of(full_parts[0][0])
            screened = raw % (first.vocab_size - 1) + 1
            mask, rec["screen"], launches["train_screen"] = screen(
                screened, device, screen_args["window"],
                screen_args["stride"], screen_args["sample_rate"])
            # every window inside either copy occurs twice
            inner = plant - screen_args["window"] - screen_args["stride"]
            copies = (bool(mask[:inner].all()),
                      bool(mask[len(raw) - plant + screen_args["stride"]:
                                len(raw) - screen_args["window"]
                                - screen_args["stride"]].all()))
            rec["screen"].update(planted_tokens=plant, copies_flagged=copies,
                                 outside_share=float(mask[plant:len(raw)
                                                          - plant].mean()))
            require(all(copies), f"phase 12: the planted copies are not "
                    f"flagged: {copies}")
            _counts_reset()
            for arch, b, s, steps, compress, dots in full_parts:
                t1 = time.perf_counter()
                rec[arch] = train_full(arch, config_of(arch), raw, screened,
                                       mask, b, s, steps, compress, dots,
                                       device)
                rec[arch]["part_s"] = time.perf_counter() - t1
            launches["lm_training_full"], _ = _counts()
        if launcher:
            rec["launcher"] = launcher_resume(device)
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    for path in ("lm_training", "lm_training_full"):
        require(sum(launches.get(path, {}).values()) == 0,
                f"phase 12 launched index kernels on {path}: "
                f"{launches[path]}")
    rec["phase_s"] = time.perf_counter() - t0
    return rec, launches


# --------------------------------------------------------------------------
# phase 13: the launch tools (dryrun, perf, report)
# --------------------------------------------------------------------------

LAUNCH_LM_CELLS = 40             # ten configs x four shapes
LAUNCH_PEAK_SLACK = 1.10         # measured peak over its meta estimate
LAUNCH_NEEDED = {"dryrun_index_build": ("radix_hist", "radix_pos",
                                        "char_histogram"),
                 "dryrun_index_serve": ("rank_select",)}


def check_launch_cell(rec: dict, what: str) -> None:
    """A measured time under its roofline bound, or a measured peak over
    its meta estimate by more than ``LAUNCH_PEAK_SLACK``, is a broken
    measurement (an estimate that says "fits" where the card runs out is
    the failure that matters)."""
    require(rec["measured_s"] >= rec["bound_s"],
            f"{what}: {rec['measured_s']} s is under its {rec['bound_by']} "
            f"bound {rec['bound_s']} s")
    peak, est = rec.get("peak_bytes"), rec["estimate"]["memory"]
    if peak is not None:
        require(peak <= LAUNCH_PEAK_SLACK * est["total_bytes"],
                f"{what}: measured peak {peak} B exceeds its estimate "
                f"{est['total_bytes']} B by more than "
                f"{LAUNCH_PEAK_SLACK - 1:.0%}")


def phase_launch(device="cuda", config_of=None, icfg=None, jobs=None,
                 max_decode_batch=None, workdir=None) -> tuple:
    """Phase 13: (a) ``dryrun.main`` over every cell (the LM cells traced
    on meta in ``jobs`` processes, long_500k skipped where the reference
    skips it; the two bwt_index cells built and served in a one-rank
    world), (b) ``perf``'s three targets, then ``report.main``'s tables.
    Returns (record, launches by path: the index cells' own counts, reset
    just before each counted run and read just after, and perf's
    bwt_build, reset before it and read after)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun, perf, report
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.specs import shape_skip_reason

    config_of = config_of or get_config
    jobs = jobs or min(8, os.cpu_count() or 1)
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    rec, launches = {}, {}
    if cuda:    # what earlier phases still hold: perf's budget is the rest
        rec["allocated_at_start"] = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_",
                                     dir=workdir) as tmp:
        dr_dir, pf_dir = Path(tmp) / "dryrun", Path(tmp) / "perf"
        cells = dryrun.main(["--out", str(dr_dir), "--jobs", str(jobs)],
                            config_of=config_of, index_cfg=icfg,
                            index_device=device)
        rec["dryrun_s"] = time.perf_counter() - t0
        lm = [c for c in cells if c["arch"] != "bwt_index"]
        require(len(lm) == LAUNCH_LM_CELLS, f"phase 13: {len(lm)} LM cells")
        for c in lm:
            cfg = config_of(c["arch"])
            skip = shape_skip_reason(cfg, c["shape"])
            require(c["status"] == ("skipped" if skip else "traced")
                    and c.get("reason") == skip,
                    f"phase 13: cell {c['arch']} x {c['shape']}: "
                    f"{c['status']} ({c.get('reason')})")
        rec["lm_cells"] = {
            f"{c['arch']}__{c['shape']}": (
                {"status": "skipped"} if c["status"] == "skipped" else
                {"status": "traced",
                 "total_gib": c["memory"]["total_bytes"] / 2**30,
                 "fits": c["memory"]["fits"], "trace_s": c["trace_s"],
                 "flops": c["counts"]["flops"],
                 "bytes": c["counts"]["bytes"],
                 "bottleneck": c["roofline"]["bottleneck"],
                 "useful_flops_ratio": c["roofline"]["useful_flops_ratio"]})
            for c in lm}
        rec["lm_traced"] = sum(c["status"] == "traced" for c in lm)
        rec["lm_trace_s"] = sum(c.get("trace_s", 0.0) for c in lm)
        for c in cells:
            if c["arch"] != "bwt_index":
                continue
            path = f"dryrun_index_{c['shape']}"
            launches[path] = c["launches"]
            counts = c["counts"]
            # on the card each needed kernel launched and reported its
            # bytes; on the CPU the plain versions ran inside the wrappers
            require(bool(counts["kernel_bytes"]),
                    f"phase 13 {path}: no kernel wrapper reported bytes")
            bound = counts["bytes"] / rf.HBM_BW
            if cuda:
                for name in LAUNCH_NEEDED[path]:
                    require(c["launches"][name] > 0
                            and counts["kernel_bytes"].get(name, 0) > 0,
                            f"phase 13: kernel {name} never launched on "
                            f"{path}")
                require(c["seconds"] >= bound,
                        f"phase 13 {path}: {c['seconds']} s is under its "
                        f"bytes bound {bound} s")
            rec[path] = {k: c[k] for k in (
                "tokens", "seconds", "peak_bytes", "collectives",
                "launches", "roofline") if k in c}
            rec[path].update(bound_s=bound, bytes=counts["bytes"],
                             kernel_bytes=counts["kernel_bytes"],
                             in_scope_bytes=counts["in_scope_bytes"],
                             count_s=counts["seconds"])
        t1 = time.perf_counter()
        runs = perf.qwen_train(out_dir=pf_dir, device=device,
                               config_of=config_of)
        runs += perf.musicgen_decode(out_dir=pf_dir, device=device,
                                     config_of=config_of,
                                     max_batch=max_decode_batch)
        _counts_reset()
        runs += perf.bwt_build(out_dir=pf_dir, device=device, icfg=icfg)
        launches["perf_bwt_build"], _ = _counts()
        rec["perf_s"] = time.perf_counter() - t1
        for r in runs:
            what = f"phase 13 {r['target']}/{r['variant']}"
            if r["status"] == "measured" and "bound_s" in r:
                if cuda:
                    check_launch_cell(r, what)
                require(r["finite"], f"{what}: non-finite values")
        base = [r for r in runs if r["target"] == "bwt_build"
                and r["variant"] == "baseline"]
        require(len(base) == 1 and base[0]["sa_equals_baseline"],
                "phase 13: bwt_build baseline")
        rec["perf"] = {f"{r['target']}/{r['variant']}": {
            k: r[k] for k in (
                "status", "reason", "measured_s", "bound_s", "micro_s",
                "adamw_s", "extrapolated_step_s", "ms_per_step", "batch",
                "peak_bytes", "sa_equals_baseline", "sa_positions_differing",
                "capacity_factor_used", "overflow_retried") if k in r}
            | ({"estimate_bytes": r["estimate"]["memory"]["total_bytes"],
                "estimate_fits": r["estimate"]["memory"]["fits"]}
               if "estimate" in r else {})
            for r in runs}
        require(not cuda or launches["perf_bwt_build"]["radix_hist"] > 0,
                "phase 13: perf's bwt_build launched no radix_hist")
        report.main(["--dryrun", str(dr_dir), "--perf", str(pf_dir)])
    if cuda:
        total = torch.cuda.get_device_properties(0).total_memory
        rec["hbm_bytes"] = {"card": total, "roofline": rf.HBM_BYTES}
        require(total >= rf.HBM_BYTES,
                f"phase 13: the card holds {total} B, under the estimates' "
                f"HBM_BYTES {rf.HBM_BYTES}")
    rec["phase_s"] = time.perf_counter() - t0
    return rec, launches


# --------------------------------------------------------------------------
# phase 14: LM serving in a world of ranks
# --------------------------------------------------------------------------

LM_MOE = ("deepseek_v2_236b", "llama4_maverick_400b_a17b")
# (ranks, mesh, configs (None: all ten)): gloo ranks sharing the card
LM_WORLDS = ((4, {"pod": 1, "data": 2, "model": 2}, None),
             (8, {"pod": 2, "data": 2, "model": 2}, LM_MOE))
LM_WORLD_B, LM_WORLD_S = 4, 16
LM_WORLD_TIMEOUT_S = 600
LM_WORLD_FULL_MESH = {"pod": 1, "data": 1, "model": 2}
# phase 15 (a): the configs whose world step also runs with compression;
# the state the updates start from (moments of a run under way: from zero
# moments AdamW's first step is g / (|g| + eps), whose rounding noise on a
# near-zero gradient reaches lr itself); |g / scale| this close to an int8
# rounding boundary may round either way
LM_TRAIN_COMPRESS = ("qwen2p5_3b",)
LM_TRAIN_M0, LM_TRAIN_V0, LM_TRAIN_ERR0 = 1e-3, 1e-6, 1e-4
LM_TRAIN_TIE = 1e-3
# the full-width parts: (name, config id, depth cut, dtype, forward (B, S),
# generate (B, prompt, new) or None); minitron_4b's new tokens cut from 16
# to 8 to pay for phase 15
LM_WORLD_FULL = (
    ("minitron_4b", "minitron_4b", None, "float32", (8, 256), (8, 4, 8)),
    ("deepseek_v2_236b", "deepseek_v2_236b", 3, "bfloat16", (4, 1024),
     None),
)


def lm_world_rank(mesh, spec: dict) -> dict:
    """One rank of phase 14 (a): each reduced config of ``spec["archs"]``
    in float32 on ``spec["device"]``, weights drawn on the CPU from a
    seeded generator (the rank's blocks, ``TRAIN_RULES``): forward at B =
    4, S = 16, decode logits along 8 tokens and generate 4 + 8 tokens, the
    global arrays on rank 0; the decode logits along its own tokens when
    ``spec["tie_logits"]``; then, with ``spec["train"]``, phase 15 (a):
    the config's train step on the same weights (``lm_world_train_case``;
    qwen2p5_3b also with compression); the rank's kernel launches and
    collectives."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core import dist_sort
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import generate
    from repro_torch.sharding import TRAIN_RULES, gather_global, world_context

    dev = spec["device"]
    ctx = world_context(mesh, TRAIN_RULES)
    first = dist.get_rank() == 0
    out = {"transport": dist_sort.transport(
        dist_sort.axis_info(mesh, "model"), dev), "train": {}}
    _counts_reset()
    B, S = LM_WORLD_B, LM_WORLD_S
    for arch in spec["archs"]:
        cfg = get_reduced_config(arch)
        params = tf.init_model(cfg, torch.Generator().manual_seed(0),
                               torch.float32, dev, ctx)
        with torch.no_grad():
            fwd = tf.forward(params, lm_batch(cfg, B, S, dev), cfg, ctx)
            rec = {"forward": gather_global(
                fwd, ctx, ("batch", None, "act_model"),
                (B, S, cfg.vocab_size))}
            toks = lm_batch(cfg.replace(frontend="none"), B, LM_DECODE, dev,
                            seed=1)["tokens"]
            rec["decode"] = lm_decode(params, cfg, toks, torch.float32, ctx)
            res = generate(params, cfg, ctx, toks[:, :LM_PROMPT].cpu().numpy(),
                           LM_NEW)
            rec["tokens"] = res.tokens
            if spec["tie_logits"]:
                rec["tie_logits"] = lm_decode(
                    params, cfg, torch.from_numpy(res.tokens[:, :-1]).to(dev),
                    torch.float32, ctx)
        if first:
            out[arch] = rec
        if spec.get("train"):
            out["train"][arch] = lm_world_train_case(
                params, cfg, ctx, dev, arch in LM_TRAIN_COMPRESS)
    out["launches"], out["collectives"] = _counts()
    return out


def lm_world_train_case(params, cfg, ctx, dev, compressed: bool) -> dict:
    """Phase 15 (a) in one rank: the gradient blocks of ``loss_fn`` at B =
    4, S = 16 on the english corpus (remat "none": phase 15 (b) and the
    CPU tests take the remat policies), summed over each leaf's replicated
    axes, then the updates ``make_train_step`` makes of them from a
    state under way (moments LM_TRAIN_M0 / LM_TRAIN_V0; with compression
    an error buffer of LM_TRAIN_ERR0), on copies of ``params``: the
    metrics and the updated param / m / v (/ error) blocks; for the
    compressed update (with ``compressed``, beside the plain one), which
    elements lie within LM_TRAIN_TIE of an int8 rounding boundary (either
    rounding is right there)."""
    import torch

    from repro_torch.data.corpus import corpus
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.sharding import axes_of, pmax, reduce_gradients
    from repro_torch.training import compression
    from repro_torch.training.optimizer import AdamWConfig, adamw_update

    toks = corpus("english", 1 << 12) % (cfg.vocab_size - 1) + 1
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenLoader(
        toks, LoaderConfig(LM_WORLD_B, LM_WORLD_S, seed=3)).batch(0).items()}
    specs = tf.model_shardings(cfg, ctx)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = tf.loss_fn(live, batch, cfg, ctx, remat_policy="none")
    grads = torch.autograd.grad(loss, tree_leaves(live))
    grads = reduce_gradients(list(grads), ctx, tree_leaves(specs))
    out = {"loss_fn": loss.detach().cpu(),
           "grads": [g.cpu() for g in grads]}
    for compress in (False, True) if compressed else (False,):
        tag = "_compressed" if compress else ""
        state = {"params": copy_to(params, dev), "opt": {
            "m": tree_map(lambda t: torch.full_like(t, LM_TRAIN_M0), params),
            "v": tree_map(lambda t: torch.full_like(t, LM_TRAIN_V0), params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}}
        g = [t.clone() for t in grads]
        if compress:
            err = [torch.full_like(t, LM_TRAIN_ERR0) for t in g]
            out["ties"], out["scales"] = [], []
            with torch.no_grad():
                for t, e, spec in zip(g, err, tree_leaves(specs)):
                    g32 = t.float() + e
                    scale = torch.clamp(pmax(
                        g32.abs().max(), ctx,
                        [a for x in spec for a in axes_of(x)], "compress")
                        / 127.0, min=1e-12)
                    frac = (g32.abs() / scale).cpu()
                    out["ties"].append((frac - frac.floor() - 0.5).abs()
                                       < LM_TRAIN_TIE)
                    out["scales"].append(float(scale))
            g, err = compression.compressed_grads(g, err, ctx,
                                                  tree_leaves(specs))
        leaves = tree_leaves(state["params"])
        _, _, metrics = adamw_update(
            g, {"m": tree_leaves(state["opt"]["m"]),
                "v": tree_leaves(state["opt"]["v"]),
                "count": state["opt"]["count"]}, leaves,
            AdamWConfig(**TRAIN_ADAMW), ctx, tree_leaves(specs))
        out[f"state{tag}"] = [t.cpu() for _, t in state_leaves(state)]
        if compress:
            out[f"state{tag}"] += [t.cpu() for t in err]
        out.update({f"{k}{tag}": v.cpu() for k, v in metrics.items()})
    return out


def lm_world_reduced(device, archs=None, train: bool = False
                     ) -> tuple[dict, dict, dict]:
    """Phase 14 (a): each world of ``LM_WORLDS`` on ``device`` against the
    same world on the CPU, all the worlds side by side; with ``train``
    the same ranks also take phase 15 (a)'s train steps, each rank's
    against its CPU twin.  Returns (record, phase 15 (a)'s record, launches
    summed over the ranks on the card)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.launch.mesh import run_world

    every = [a for a in ARCH_IDS if a != "bwt_index"]
    worlds = [(parts, axes, [a for a in (names or every)
                             if archs is None or a in archs])
              for parts, axes, names in LM_WORLDS]
    worlds = [w for w in worlds if w[2]]

    def run(parts, axes, names, where, dev):
        t0 = time.perf_counter()
        ranks = run_world(parts, lm_world_rank,
                          {"archs": names, "device": dev,
                           "tie_logits": where == "cpu", "train": train},
                          mesh_shape=axes, timeout_s=LM_WORLD_TIMEOUT_S)
        return ranks, time.perf_counter() - t0

    with ThreadPoolExecutor(2 * len(worlds)) as pool:
        futures = {(w[0], where): pool.submit(run, *w, where, dev)
                   for w in worlds
                   for where, dev in (("card", device), ("cpu", "cpu"))}
        done = {k: f.result() for k, f in futures.items()}
    rec, trained, launches = {}, {}, {}
    for parts, axes, names in worlds:
        runs = {where: done[(parts, where)][0] for where in ("card", "cpu")}
        runs.update({f"{where}_s": done[(parts, where)][1]
                     for where in ("card", "cpu")})
        card, cpu = runs["card"][0], runs["cpu"][0]
        world = f"{parts}_ranks"
        rec[world] = {"mesh": axes, "transport": card["transport"],
                      "card_s": runs["card_s"], "cpu_s": runs["cpu_s"],
                      "collectives_rank0": card["collectives"]}
        for r in runs["card"]:
            for name, v in r["launches"].items():
                launches[name] = launches.get(name, 0) + v
        for arch in names:
            tol = LM_MOE_TOL if arch in LM_MOE else LM_TOL
            what = f"phase 14 {world} {arch}"
            got, want = card[arch], cpu[arch]
            rec[world][arch] = {
                "tol": tol,
                "forward_err": require_close(
                    torch.from_numpy(got["forward"]),
                    torch.from_numpy(want["forward"]), tol,
                    f"{what} forward"),
                "decode_err": require_close(
                    torch.from_numpy(got["decode"]),
                    torch.from_numpy(want["decode"]), tol, f"{what} decode"),
                "generate_rows_differ": tokens_agree(
                    got["tokens"], want["tokens"],
                    torch.from_numpy(want["tie_logits"]), LM_PROMPT, tol,
                    f"{what} generate")}
        if train:
            trained[world] = {"mesh": axes}
            for arch in names:
                card = [r["train"][arch] for r in runs["card"]]
                cpu = [r["train"][arch] for r in runs["cpu"]]
                for tag in ("", "_compressed") if arch in LM_TRAIN_COMPRESS \
                        else ("",):
                    trained[world][arch + tag] = lm_world_train_check(
                        card, cpu, tag,
                        LM_MOE_TOL if arch in LM_MOE else LM_TOL,
                        f"phase 15 {world} {arch}{tag}")
    return rec, trained, launches


def lm_world_train_check(card: list, cpu: list, tag: str, grad_tol: float,
                         what: str) -> dict:
    """Phase 15 (a): each rank's train step on the card against its twin
    on the CPU: the loss, grad_norm and lr within LM_STEP_TOL of 1 + |b|,
    every gradient block within ``grad_tol``, every updated param /
    moment (/ error) block within LM_STEP_TOL, every rank the same
    metrics; for the compressed update (``tag``) the elements at an int8
    rounding tie on the CPU are left out of the state and their error
    within one level.  Returns the worst errors and the number of
    ties."""
    import torch

    t = torch.from_numpy
    out = {"grad_tol": grad_tol, "ranks": len(card)}
    for k in ("loss_fn", f"grad_norm{tag}", f"lr{tag}"):
        out[f"{k}_err"] = max(require_close(t(a[k]), t(b[k]), LM_STEP_TOL,
                                            f"{what} {k} rank {r}")
                              for r, (a, b) in enumerate(zip(card, cpu)))
        require(len({float(a[k]) for a in card}) == 1,
                f"{what}: ranks disagree on {k}")
    out["grad_err"] = max(
        require_close(t(g), t(h), grad_tol, f"{what} gradient {i} rank {r}")
        for r, (a, b) in enumerate(zip(card, cpu))
        for i, (g, h) in enumerate(zip(a["grads"], b["grads"])))
    errs, ties = [0.0], 0
    for r, (a, b) in enumerate(zip(card, cpu)):
        n = len(b["grads"])
        for i, (g, h) in enumerate(zip(a[f"state{tag}"], b[f"state{tag}"])):
            g, h = t(g), t(h)
            if tag:
                tie = t(b["ties"][i % n])
                if i >= 3 * n:          # the error buffer: one level
                    off = (g - h).abs()[tie]
                    require(bool((off <= 1.001 * b["scales"][i % n]
                                  + LM_STEP_TOL).all()),
                            f"{what} error {i % n} rank {r}: more than one "
                            f"int8 level off at a rounding tie")
                    ties += int(tie.sum())
                g, h = g[~tie], h[~tie]
            errs.append(require_close(g, h, LM_STEP_TOL,
                                      f"{what} state {i} rank {r}"))
    out["state_err"] = max(errs)
    if tag:
        out["ties"] = ties
    out["loss"] = float(cpu[0]["loss_fn"])
    out["grad_norm"] = float(cpu[0][f"grad_norm{tag}"])
    return out


def lm_world_full_rank(mesh, spec: dict) -> dict:
    """One rank of phase 14 (b) / (c): each part of ``spec["parts"]`` at
    full width (weights drawn on ``spec["device"]`` from a seeded
    generator, the rank's blocks, ``DECODE_RULES``): the local shapes of
    its heads and experts, forward(last_token_only) timed, greedy generate
    timed with the collectives of its steps, the peak; the global logits
    and tokens on rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import base
    from repro_torch.core import dist_sort
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import generate
    from repro_torch.sharding import DECODE_RULES, gather_global, world_context

    get_config = getattr(base, spec["config"])
    dev = spec["device"]
    ctx = world_context(mesh, DECODE_RULES)
    out = {"launches": {}}
    mem = DeviceMemory(dev)
    for name, arch, layers, dtype, fwd, gen in spec["parts"]:
        cfg = get_config(arch)
        cfg = cfg if layers is None else cfg.replace(num_layers=layers)
        dtype = getattr(torch, dtype)
        mem.reset_peak()
        _counts_reset()
        params, init_s = timed(lambda: tf.init_model(
            cfg, torch.Generator(dev).manual_seed(0), dtype, dev, ctx), dev)
        mixer = (params["blocks"]["s0"]["mixer"] if params["blocks"]
                 else params["suffix"][0]["mixer"])
        rec = {"init_s": init_s, "weights_gib": mem.allocated_gib(),
               "local_heads": mixer["wo"].shape[1]}
        if cfg.num_experts:
            rec["local_experts"] = params["blocks"]["s0"]["ffn"][
                "w_gate"].shape[1]
        fb, fs = fwd
        batch = {"tokens": torch.from_numpy(lm_tokens(cfg, fb, fs)).to(dev)}
        with torch.no_grad():
            call = lambda: tf.forward(params, batch, cfg, ctx,  # noqa: E731
                                      last_token_only=True)
            logits, rec["forward_first_s"] = timed(call, dev)
            logits, rec["forward_s"] = timed(call, dev)
            logits = gather_global(logits, ctx, ("batch", None, "act_model"),
                                   (fb, 1, cfg.vocab_size))
            if gen:
                gb, prompt, new = gen
                prompts = lm_tokens(cfg, gb, prompt)
                generate(params, cfg, ctx, prompts, 2, dtype=dtype)  # warm
                dist_sort.reset_collectives()
                res = generate(params, cfg, ctx, prompts, new, dtype=dtype)
                steps = prompt + new - 1
                rec["generate"] = {
                    "batch": gb, "prompt": prompt, "new": new,
                    "steps": steps, "tokens_per_s": res.tokens_per_s,
                    "s_per_step": gb / res.tokens_per_s,
                    "collectives_per_step": {
                        k: v / steps for k, v in
                        dist_sort.COLLECTIVES.items() if v},
                    "collective_bytes_per_step": {
                        k: (v[0] + v[1]) / steps for k, v in
                        dist_sort.COLLECTIVE_BYTES.items() if v[0]}}
        rec["peak_gib"] = mem.peak_gib()
        launches, _ = _counts()
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        if dist.get_rank() == 0:
            rec["logits"] = logits.float()
            if gen:
                rec["tokens"] = res.tokens
        out[name] = rec
        del params, logits
        mem.reset_peak()
    return out


def lm_tokens(cfg, B: int, S: int):
    import numpy as np

    return np.random.default_rng(S).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def lm_world_single(part, device, config: str = "get_config") -> dict:
    """The single-rank run of a full-width part on ``device``: the same
    weights (the same seeded generator), its forward(last_token_only)
    logits, and for a generate part its greedy tokens and the decode
    logits along them (for the tie rule)."""
    import torch

    from repro_torch.configs import base
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import generate
    from repro_torch.sharding import DECODE_RULES, single_device_context

    name, arch, layers, dtype, (fb, fs), gen = part
    cfg = getattr(base, config)(arch)
    cfg = cfg if layers is None else cfg.replace(num_layers=layers)
    dtype = getattr(torch, dtype)
    ctx = single_device_context(DECODE_RULES)
    mem = DeviceMemory(device)
    mem.reset_peak()
    params = tf.init_model(cfg, torch.Generator(device).manual_seed(0),
                           dtype, device)
    out = {"weights_gib": mem.allocated_gib()}
    batch = {"tokens": torch.from_numpy(lm_tokens(cfg, fb, fs)).to(device)}
    with torch.no_grad():
        out["logits"], out["forward_s"] = timed(lambda: tf.forward(
            params, batch, cfg, ctx, last_token_only=True), device)
        out["logits"] = out["logits"].float().cpu()
        if gen:
            gb, prompt, new = gen
            res = generate(params, cfg, ctx, lm_tokens(cfg, gb, prompt), new,
                           dtype=dtype)
            out["tokens"] = res.tokens
            out["s_per_step"] = gb / res.tokens_per_s
            out["tie_logits"] = lm_decode(
                params, cfg, torch.from_numpy(res.tokens[:, :-1]).to(device),
                dtype).float().cpu()
    out["peak_gib"] = mem.peak_gib()
    del params
    mem.reset_peak()
    return out


def lm_world_full(device, parts=LM_WORLD_FULL,
                  config: str = "get_config") -> tuple[dict, dict]:
    """Phase 14 (b) / (c): each part's single-rank run in this process,
    then all parts in one world of ``LM_WORLD_FULL_MESH`` on ``device``:
    the forward logits within LM_TOL (float32) or LM_BF16_TOL of the max
    |logit| (bf16) of the single run's, the greedy tokens equal but at a
    near tie.  ``config`` names the function of ``configs.base`` that
    gives the configs (the CPU rehearsal takes the reduced ones).  Returns
    (record, launches over the world's ranks)."""
    import torch

    from repro_torch.launch.mesh import run_world

    singles = {p[0]: lm_world_single(p, device, config) for p in parts}
    n = 1
    for v in LM_WORLD_FULL_MESH.values():
        n *= v
    t0 = time.perf_counter()
    ranks = run_world(n, lm_world_full_rank, {"parts": parts,
                                              "device": device,
                                              "config": config},
                      mesh_shape=LM_WORLD_FULL_MESH,
                      timeout_s=LM_WORLD_TIMEOUT_S)
    rec = {"mesh": LM_WORLD_FULL_MESH, "world_s": time.perf_counter() - t0}
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for name, arch, layers, dtype, fwd, gen in parts:
        one, world = singles[name], ranks[0][name]
        what = f"phase 14 {name} world of {n}"
        got, want = torch.from_numpy(world.pop("logits")), one["logits"]
        part = {"single": {k: v for k, v in one.items()
                           if k not in ("logits", "tokens", "tie_logits")},
                "ranks": [{k: v for k, v in r[name].items()
                           if k not in ("logits", "tokens")} for r in ranks],
                "forward_max_err": max_err(got, want),
                "max_abs_logit": float(want.abs().max())}
        if dtype == "float32":
            require_close(got, want, LM_TOL, f"{what} forward")
        else:
            require(bool(torch.isfinite(got).all())
                    and part["forward_max_err"]
                    <= LM_BF16_TOL * part["max_abs_logit"],
                    f"{what} forward differs by {part['forward_max_err']} "
                    f"(max |logit| {part['max_abs_logit']}, tol "
                    f"{LM_BF16_TOL} of it)")
        if gen:
            part["generate_rows_differ"] = tokens_agree(
                world["tokens"], one["tokens"], one["tie_logits"], gen[1],
                LM_TOL if dtype == "float32" else LM_BF16_TOL, f"{what} "
                f"generate")
        rec[name] = part
    return rec, launches


def phase_lm_world(device="cuda", archs=None, full: bool = True,
                   train: bool = False) -> tuple:
    """Phase 14: (a) the reduced configs in worlds of ranks sharing
    ``device`` against the same worlds on the CPU (``archs``: all ten),
    with ``train`` also phase 15 (a)'s train steps in the same ranks;
    (b) / (c) the full-width parts when ``full``.  Returns (record,
    launches over the phase, phase 15 (a)'s record or None): it launches
    no kernel of the index."""
    t0 = time.perf_counter()
    _counts_reset()
    rec, trained, launches = lm_world_reduced(device, archs, train)
    rec = {"reduced": rec, "reduced_s": time.perf_counter() - t0}
    if full:
        t1 = time.perf_counter()
        rec["full"], more = lm_world_full(device)
        rec["full_s"] = time.perf_counter() - t1
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v
    here, _ = _counts()
    for k, v in here.items():
        launches[k] = launches.get(k, 0) + v
    require(sum(launches.values()) == 0,
            f"phase 14 launched index kernels: {launches}")
    rec["phase_s"] = time.perf_counter() - t0
    return rec, launches, (trained if train else None)


# --------------------------------------------------------------------------
# phase 15: LM training in a world of ranks
# --------------------------------------------------------------------------

# (b): qwen2p5_3b at full width in a world of 4; its depth cut (see
# PERF.md section 4 for why), batch, sequence and steps
LM_TRAIN_WORLD = dict(arch="qwen2p5_3b", layers=4, batch=4, seq=1024,
                      steps=3, mesh={"pod": 1, "data": 2, "model": 2},
                      config="get_config")


def lm_train_setup(spec: dict):
    """(config cut to ``spec["layers"]``, TrainConfig, loader) of phase 15
    (b): remat "full", the english corpus mapped into the vocabulary."""
    from repro_torch.configs import base
    from repro_torch.data.corpus import corpus
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig

    cfg = getattr(base, spec["config"])(spec["arch"]).replace(
        num_layers=spec["layers"])
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                       total_steps=spec["steps"]),
                       remat_policy="full", checkpoint_every=0)
    toks = corpus("english", 1 << 17) % (cfg.vocab_size - 1) + 1
    return cfg, tcfg, TokenLoader(toks, LoaderConfig(
        spec["batch"], spec["seq"], seed=0))


def lm_train_steps(cfg, ctx, tcfg, loader, steps: int, device, state):
    """``steps`` train steps from ``state`` under deterministic
    algorithms: (state, per step: loss, grad_norm, s and this rank's
    collectives by kind and pass)."""
    import torch

    from repro_torch import sharding
    from repro_torch.training.train_loop import (
        deterministic_algorithms,
        make_train_step,
    )

    step = make_train_step(cfg, ctx, tcfg)
    done = int(state["opt"]["count"])
    out = []
    with deterministic_algorithms():
        for i in range(done, done + steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in loader.batch(i).items()}
            sharding.reset_traffic()
            (state, m), sec = timed(lambda: step(state, batch), device)
            out.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]), "s": sec,
                        "collectives": {k: list(v) for k, v in
                                        sharding.TRAFFIC.items()}})
    return state, out


def lm_world_train_rank(mesh, spec: dict) -> dict:
    """One rank of phase 15 (b): the rank's blocks of the train state
    (``init_train_state`` from the seeded generator on the card), its
    steps with their times and collectives, a world checkpoint of the
    step before the last (``Checkpointer.save_async`` with the state's
    specs: the gather to rank 0 now, rank 0's write beside the last
    step), restored, and the last step taken again from it; peak
    memory."""
    import torch
    import torch.distributed as dist

    from repro_torch.sharding import TRAIN_RULES, world_context
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.train_loop import (
        init_train_state,
        state_shardings,
    )

    dev = spec["device"]
    ctx = world_context(mesh, TRAIN_RULES)
    cfg, tcfg, loader = lm_train_setup(spec)
    mem = DeviceMemory(dev)
    mem.reset_peak()
    _counts_reset()
    state, init_s = timed(lambda: init_train_state(
        cfg, torch.Generator(dev).manual_seed(0), tcfg, torch.float32, dev,
        ctx), dev)
    rec = {"init_s": init_s, "state_gib": mem.allocated_gib()}
    shardings = state_shardings(cfg, ctx, tcfg)
    ckpt = Checkpointer(spec["ckpt_dir"], keep=1)
    state, first = lm_train_steps(cfg, ctx, tcfg, loader,
                                  spec["steps"] - 1, dev, state)
    _, rec["gather_s"] = timed(lambda: ckpt.save_async(
        spec["steps"] - 1, state, ctx=ctx, shardings=shardings), dev)
    state, last = lm_train_steps(cfg, ctx, tcfg, loader, 1, dev, state)
    _, rec["write_wait_s"] = timed(ckpt.wait, dev)
    dist.barrier()                      # rank 0's write is on disk
    rec["steps"] = first + last
    rec["peak_gib"] = mem.peak_gib()
    (state, _), rec["restore_s"] = timed(lambda: ckpt.restore(
        state, shardings=shardings, ctx=ctx), dev)
    state, again = lm_train_steps(cfg, ctx, tcfg, loader, 1, dev, state)
    rec["resumed"] = again[0]
    rec["launches"], _ = _counts()
    del state
    mem.reset_peak()
    return rec


def lm_train_single(spec: dict, device) -> dict:
    """Phase 15 (b)'s reference: the same cut trained on one rank in this
    process, phase 12's path (``init_train_state`` from the same seeded
    generator, ``make_train_step`` on a single-device context): per step
    loss, grad_norm and s, and the peak."""
    import torch

    from repro_torch.sharding import single_device_context
    from repro_torch.training.train_loop import init_train_state

    cfg, tcfg, loader = lm_train_setup(spec)
    mem = DeviceMemory(device)
    mem.reset_peak()
    state = init_train_state(cfg, torch.Generator(device).manual_seed(0),
                             tcfg, torch.float32, device)
    state, steps = lm_train_steps(cfg, single_device_context(), tcfg, loader,
                                  spec["steps"], device, state)
    out = {"steps": steps, "peak_gib": mem.peak_gib()}
    del state
    mem.reset_peak()
    return out


def lm_world_train(device, spec=LM_TRAIN_WORLD) -> tuple[dict, dict]:
    """Phase 15 (b): ``spec``'s cut trained on one rank here, then in a
    world of ``spec["mesh"]`` on ``device``: the losses and grad norms
    within LM_TOL of 1 + |b| of the single rank's, the repeated last step
    equal bit for bit; s a step (the warm steps: the second and the
    repeated last), rank 0's collectives a step by kind, pass and bytes,
    each rank's peak; the checkpoint's gather, write and restore.
    Returns (record, launches over the world's ranks)."""
    from repro_torch.launch.mesh import run_world
    from repro_torch.models import transformer as tf

    cfg, _, _ = lm_train_setup(spec)
    t0 = time.perf_counter()
    single = lm_train_single(spec, device)
    single_s = time.perf_counter() - t0
    n = 1
    for v in spec["mesh"].values():
        n *= v
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_train_",
                                 dir=ROOT / "build"))
    t1 = time.perf_counter()
    try:
        ranks = run_world(n, lm_world_train_rank,
                          dict(spec, device=device, ckpt_dir=str(work)),
                          mesh_shape=spec["mesh"],
                          timeout_s=LM_WORLD_TIMEOUT_S)
        ckpt_bytes = sum(f.stat().st_size for f in work.rglob("*")
                         if f.is_file())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    world_s = time.perf_counter() - t1
    what = f"phase 15 {spec['arch']} world of {n}"
    got, want = ranks[0]["steps"], single["steps"]
    for k in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(got, want)):
            require(abs(a[k] - b[k]) <= LM_TOL * (1 + abs(b[k])),
                    f"{what} step {i + 1} {k}: {a[k]} against the single "
                    f"rank's {b[k]}")
        require(len({r["steps"][-1][k] for r in ranks}) == 1,
                f"{what}: the ranks disagree on {k}")
    again = ranks[0]["resumed"]
    require(again["loss"] == got[-1]["loss"]
            and again["grad_norm"] == got[-1]["grad_norm"],
            f"{what}: step {spec['steps']} resumed from the world "
            f"checkpoint gives loss {again['loss']}, grad_norm "
            f"{again['grad_norm']}, not {got[-1]['loss']}, "
            f"{got[-1]['grad_norm']}")
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # the warm steps: the second, and the last taken again after the
    # restore (the last itself ran beside rank 0's checkpoint write)
    warm = got[1:-1] + [again] if len(got) > 2 else got
    kinds = sorted({k for st in warm for k in st["collectives"]})
    per_step = {k: [sum(st["collectives"].get(k, [0, 0])[j] for st in warm)
                    / len(warm) for j in (0, 1)] for k in kinds}
    rec = {"config": {k: spec[k] for k in ("arch", "layers", "batch", "seq",
                                           "steps", "mesh")},
           "params": tf.count_params(cfg),
           "remat_policy": "full", "dtype": "float32",
           "losses": [st["loss"] for st in got],
           "grad_norms": [st["grad_norm"] for st in got],
           "single_losses": [st["loss"] for st in want],
           "single_grad_norms": [st["grad_norm"] for st in want],
           "loss_max_err": max(abs(a["loss"] - b["loss"])
                               for a, b in zip(got, want)),
           "s_per_step": sum(st["s"] for st in warm) / len(warm),
           "step_s": [st["s"] for st in got],
           "collectives_per_step": {k: v[0] for k, v in per_step.items()},
           "collective_bytes_per_step": {k: v[1]
                                         for k, v in per_step.items()},
           "resumed_bitwise": True,
           "peak_gib_per_rank": [r["peak_gib"] for r in ranks],
           "state_gib_per_rank": [r["state_gib"] for r in ranks],
           "init_s": ranks[0]["init_s"], "gather_s": ranks[0]["gather_s"],
           "write_wait_s": ranks[0]["write_wait_s"],
           "restore_s": ranks[0]["restore_s"], "checkpoint_bytes": ckpt_bytes,
           "world_s": world_s, "single_s": single_s,
           "single": {"s_per_step": sum(st["s"] for st in
                                        (want[1:] or want))
                      / len(want[1:] or want),
                      "step_s": [st["s"] for st in want],
                      "peak_gib": single["peak_gib"]}}
    return rec, launches


def phase_lm_train(device="cuda", reduced=None, archs=None,
                   spec=LM_TRAIN_WORLD) -> tuple:
    """Phase 15: (a) phase 14 (a)'s worlds' train steps (``reduced``, or
    those worlds run here when phase 14 did not run), (b) ``spec``'s
    full-width world (None: skipped).  Returns (record, launches over the
    phase): it launches no kernel of the index."""
    t0 = time.perf_counter()
    _counts_reset()
    launches = {}
    if reduced is None:
        _, reduced, launches = lm_world_reduced(device, archs, train=True)
    rec = {"reduced": reduced, "reduced_s": time.perf_counter() - t0}
    if spec is not None:
        t1 = time.perf_counter()
        rec["full"], more = lm_world_train(device, spec)
        rec["full_s"] = time.perf_counter() - t1
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v
    here, _ = _counts()
    for k, v in here.items():
        launches[k] = launches.get(k, 0) + v
    require(sum(launches.values()) == 0,
            f"phase 15 launched index kernels: {launches}")
    rec["phase_s"] = time.perf_counter() - t0
    return rec, launches


# the function of the JAX package each kernel replaces (file:line of the
# function that reaches pl.pallas_call)
REPLACES = {
    "rank_packed": "src/repro/kernels/rank_select.py:133",
    "rank_select": "src/repro/kernels/rank_select.py:179",
    "radix_hist": "src/repro/kernels/radix_hist.py:25",
    "radix_pos": "src/repro/kernels/radix_sort.py:54",
    "rerank_scan": "src/repro/kernels/rerank_scan.py:54",
    "char_histogram": "src/repro/kernels/char_histogram.py:30",
    "fm_query_packed": "src/repro/kernels/rank_select.py:133",
    "fm_query_unpacked": "src/repro/kernels/rank_select.py:179",
    "merge_walk": "src/repro/kernels/rank_select.py:133",
    "fm_query_stacked_packed": "src/repro/kernels/rank_select.py:133",
    "fm_query_stacked_unpacked": "src/repro/kernels/rank_select.py:179",
}


def kernels_line(rows: dict, main_launches: dict, path_launches: dict):
    """The ``kernels`` line: one entry per kernel of ``_build.KERNELS``
    with its source, the TPU kernel it replaces, its launches on the main
    paths (and per path) and its row's numbers."""
    from repro_torch.kernels import _build

    src = "src/repro_torch/kernels/csrc/{}.cu"
    return {"kernels": [
        {"name": name, "route": "cuda",
         "source": src.format(_build.KERNELS[name]),
         "replaces": REPLACES[name], "launches": main_launches[name],
         "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name].get("bound_by", "bytes"),
         "library_ms": rows[name]["library_ms"],
         "device_ms": rows[name]["device_ms"],
         "launches_by_path": {p: v[name] for p, v in path_launches.items()},
         "shape": rows[name]["shape"],
         # merge_walk's plain walks run on small walks only, and its
         # chains; the query kernels' chains of dependent steps (the
         # latency floors of the query, stacked, merge and single-batch
         # rank kernels); the rank kernels on the distributed indexes of
         # phase 10 and on the LF maps of phase 7's merges
         **{k: rows[name][k] for k in ("plain_shape", "dependent_steps",
                                       "latency_floor_ms", "chains",
                                       "events_ms", "dist", "lf_map")
            if k in rows[name]}}
        for name in _build.KERNELS]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--dna-log2n", type=int, default=28)
    ap.add_argument("--proteins-log2n", type=int, default=24)
    ap.add_argument("--parity-log2n", type=int, default=16)
    ap.add_argument("--merge-log2n", type=int, default=20,
                    help="phase 7: log2 of the largest DNA document")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build
    from repro_torch.training.train_loop import CUBLAS_WORKSPACE

    # phase 12's deterministic algorithms need a fixed cuBLAS workspace,
    # which cuBLAS reads at the process's first matmul
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    t0 = time.perf_counter()
    finish_chase = (start_chase_build() if phases & {1, 2, 3, 7, 8, 10}
                    else None)
    finish_lanes = (start_script_build(LANES_SRC, LANES_ARGTYPES)
                    if 8 in phases else None)
    finish_warp = (start_script_build(WARP_SRC, WARP_ARGTYPES)
                   if phases & {1, 7, 10} else None)
    finish_stamps = (start_script_build(STAMPS_SRC, STAMPS_ARGTYPES)
                     if phases & {1, 7, 10} else None)
    try:
        _build.build_all()
    finally:
        chase = finish_chase() if finish_chase else None
        lanes = finish_lanes() if finish_lanes else None
        warp = finish_warp() if finish_warp else None
        stamps = finish_stamps() if finish_stamps else None
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in _build.BUILD_LOG.items()}
    for src, script in ((LANES_SRC, lanes), (WARP_SRC, warp),
                        (STAMPS_SRC, stamps)):
        if script is not None:
            ptxas[src.stem] = script["ptxas"]
    warp = warp["rank_select_warp_launch"] if warp is not None else None
    stamps = (stamps["rank_select_stamps_launch"] if stamps is not None
              else None)
    emit({"phase": 0, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "ptxas": ptxas})

    from repro_torch.data.corpus import corpus

    t0 = time.perf_counter()
    dna_toks = corpus("dna", 1 << args.dna_log2n)   # phases 1, 2, 5, 6, 8
    dna_gen_s = time.perf_counter() - t0

    rows = {}
    if 1 in phases:
        rows = phase_kernels(args.dna_log2n, chase, warp, stamps)
        built = phase_build_kernels(dna_toks)
        for name, row in zip(("radix_hist", "radix_pos"),
                             built.pop("radix_qgram")):
            rows[name]["qgram"] = row
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            row["max_abs_err"])
        rows.update(built)
        emit({"phase": 1, "kernels": rows})
        small_errs, layouts = small_index_checks()
        emit({"phase": 1, "fm_query_max_abs_err": small_errs,
              "fm_query_layouts": layouts})

    main_launches = {name: 0 for name in _build.KERNELS}
    path_launches = {}
    build_kernels = ("radix_hist", "radix_pos", "rerank_scan",
                     "char_histogram")
    paths = {2: ("dna", args.dna_log2n, ("fm_query_packed",
                                         *build_kernels)),
             3: ("proteins", args.proteins_log2n, ("fm_query_unpacked",
                                                   *build_kernels))}
    kept = None
    refs = {}   # phase 10's references: phases 2 and 3 on the host
    for phase, (kind, log2n, needed) in paths.items():
        if phase not in phases:
            continue
        if kind == "dna":
            toks, gen_s = dna_toks, dna_gen_s
        else:
            t0 = time.perf_counter()
            toks = corpus(kind, 1 << log2n)
            gen_s = time.perf_counter() - t0
        launches, k, fq, ref = phase_main(kind, toks, gen_s, phase,
                                          keep=kind == "dna",
                                          snap=10 in phases, chase=chase)
        kept = k or kept
        if ref is not None:
            refs[kind] = ref
        if rows:
            rows[fq["name"]] = query_row(fq, small_errs[fq["name"]])
        for name in needed:
            require(launches[name] > 0,
                    f"phase {phase}: kernel {name} never launched")
        for name, v in launches.items():
            main_launches[name] += v
        path_launches[kind] = launches
    if kept is not None and rows:
        # char_histogram on the input the main path gives build_fm_index
        fm = kept["index"].fm
        row = hist_row(kept["index"].bwt, fm.sigma,
                       f"DNA n={len(dna_toks)} BWT")
        row["max_abs_err"] = max(row["max_abs_err"],
                                 rows["char_histogram"]["max_abs_err"])
        row["text"] = {k: rows["char_histogram"][k]
                       for k in ("ms", "plain_ms", "library_ms", "device_ms",
                                 "shape")}
        rows["char_histogram"] = row
        emit({"phase": 1, "char_histogram_on_bwt": row})

    if 4 in phases:
        rec, launches = phase_parity(args.parity_log2n)
        for kind, counts in launches.items():
            path_launches[f"single_query_{kind}"] = counts
            for name, v in counts.items():
                main_launches[name] += v
        emit({"phase": 4, "parity": rec})

    if 5 in phases:
        require(kept is not None, "phase 5 compares with phase 2's build")
        rec = phase_seed(dna_toks, kept)
        path_launches["seed"] = rec["launches"]
        emit({"phase": 5, **rec})

    fm_ckpt = None      # phase 6's checkpoint of phase 2, for phase 10
    if 6 in phases:
        require(kept is not None, "phase 6 restores phase 2's build")
        if 10 in phases:
            (ROOT / "build").mkdir(exist_ok=True)
            fm_ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_fm_ckpt_",
                                            dir=ROOT / "build")) / "index"
        rec, launches = phase_restore(kept, args.proteins_log2n,
                                      keep_ckpt=fm_ckpt)
        for name, v in launches.items():
            path_launches[f"restore_{name}"] = v
        emit({"phase": 6, **rec})
    t0 = time.perf_counter()
    parked = (park(kept["index"], "cpu") if kept is not None and 9 in phases
              else None)
    park_s = time.perf_counter() - t0
    del kept

    if 7 in phases:
        rec, launches, rows["merge_walk"] = phase_merge(
            args.merge_log2n, chase, warp, stamps)
        # the LF maps of merges (a) (packed) and (c) (unpacked)
        for name, run in (("rank_packed", "dna_kway"),
                          ("rank_select", "proteins_kway")):
            if name in rows:
                rows[name]["lf_map"] = rec["runs"][run]["lf_map"]
        for path, counts in launches.items():
            path_launches[path] = counts
            for name, v in counts.items():
                main_launches[name] += v
        emit({"phase": 7, **rec})

    if 8 in phases:
        t0 = time.perf_counter()
        rec, launches, stacked_rows = phase_catalog(
            dna_toks, args.proteins_log2n, args.merge_log2n, lanes=lanes,
            chase=chase)
        rec["phase_s"] = time.perf_counter() - t0
        rows.update(stacked_rows)
        for path, counts in launches.items():
            path_launches[path] = counts
            for name, v in counts.items():
                main_launches[name] += v
        for path, name in (("catalog_dna", "fm_query_stacked_packed"),
                           ("catalog_proteins", "fm_query_stacked_unpacked")):
            require(launches[path][name] > 0,
                    f"phase 8: kernel {name} never launched on {path}")
        emit({"phase": 8, **rec})

    if 9 in phases:
        t0 = time.perf_counter()
        if parked is not None:
            index = park(parked, "cuda")
        else:   # a run without phase 2 builds its own
            from repro_torch.core.pipeline import build_index

            index = build_index(dna_toks, sample_rate=64, sa_sample_rate=32,
                                device="cuda")
        del parked
        small = min(24, args.dna_log2n)
        rec, launches = phase_frontend(
            index, dna_toks, args.merge_log2n, launcher_log2n=small,
            dedup_log2n=small, plant_log2n=small - 4)
        del index
        rec["phase_s"] = time.perf_counter() - t0
        rec["park_to_host_s"] = park_s
        for path, counts in launches.items():
            path_launches[path] = counts
            for name, v in counts.items():
                main_launches[name] += v
        for path, name in (("frontend_closed", "fm_query_packed"),
                           ("frontend_catalog_closed",
                            "fm_query_stacked_packed"),
                           ("dedup", "fm_query_packed")):
            require(launches[path][name] > 0,
                    f"phase 9: kernel {name} never launched on {path}")
        emit({"phase": 9, **rec})

    if 10 in phases:
        try:
            rec, launches, dist_rows = phase_dist(
                dna_toks, refs, dna_log2n=args.dna_log2n,
                proteins_log2n=args.proteins_log2n,
                small_dna_log2n=min(24, args.dna_log2n),
                small_proteins_log2n=min(22, args.proteins_log2n),
                fm_ckpt=fm_ckpt, chase=chase, warp=warp, stamps=stamps)
        finally:
            if fm_ckpt is not None:
                shutil.rmtree(fm_ckpt.parent, ignore_errors=True)
        for name, row in dist_rows.items():
            if name in rows:
                rows[name]["dist"] = row
        for path, counts in launches.items():
            path_launches[path] = counts
            for name, v in counts.items():
                main_launches[name] += v
        emit({"phase": 10, **rec})

    if 11 in phases:
        rec, path_launches["lm_serving"] = phase_lm()
        emit({"phase": 11, **rec})

    if 12 in phases:
        rec, launches = phase_train()
        screened = launches["train_screen"]
        require(screened["fm_query_packed"] + screened["fm_query_unpacked"]
                > 0, "phase 12: the screen launched no query kernel")
        for path, counts in launches.items():
            path_launches[path] = counts
        for name, v in screened.items():
            main_launches[name] += v
        emit({"phase": 12, **rec})

    if 13 in phases:
        rec, launches = phase_launch()
        for path, counts in launches.items():
            path_launches[path] = counts
            for name, v in counts.items():
                main_launches[name] += v
        emit({"phase": 13, **rec})

    trained = None      # phase 15 (a), taken in phase 14's worlds
    if 14 in phases:
        rec, path_launches["lm_world"], trained = phase_lm_world(
            train=15 in phases)
        emit({"phase": 14, **rec})

    if 15 in phases:
        rec, path_launches["lm_world_train"] = phase_lm_train(
            reduced=trained)
        emit({"phase": 15, **rec})

    if {1, 2, 3, 7, 8} <= phases:
        for name in _build.KERNELS:
            r = rows[name]
            check_reading(name, r["device_ms"], r["bound_ms"], r["ms"],
                          r["shape"], r.get("bound_by", "bytes"))
        emit(kernels_line(rows, main_launches, path_launches))
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
