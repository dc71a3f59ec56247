"""Serving engine: batched LM generation over the cached decode step, and
the FM-index query server (micro-batched count/locate over a built
``SequenceIndex``) — the two serve paths.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.fm_index import PAD
from ..devices import resolve_device
from ..models import transformer as tf
from ..sharding import MeshContext, gather_global, global_argmax


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray       # (B, prompt+gen) int32
    tokens_per_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    params,
    cfg: ArchConfig,
    ctx: MeshContext,
    prompts: np.ndarray,     # (B, prompt_len) int32
    max_new_tokens: int,
    *,
    dtype=torch.float32,
    cache_dtype=None,
    sample: Callable | None = None,   # logits (B, V) -> token (B,)
) -> GenerateResult:
    """Greedy (or custom-sampled) batched generation over one cache written
    in place, on the device of ``params``.

    ``prompts`` int32[B, prompt_len]; returns all B sequences extended to
    ``prompt_len + max_new_tokens`` (int32) plus tokens/s.  Prompt tokens
    are fed one decode step at a time; ``sample`` maps logits float[B, V]
    -> token int[B] (None = argmax, ties to the lower id).  The cache is
    ``cache_dtype or dtype`` (e.g. ``torch.float8_e4m3fn``: cast on write,
    upcast on read).  The clock is read after synchronising the device.

    In a world (``ctx`` of ``sharding.world_context``, ``params`` the
    rank's blocks) every rank passes the same global ``prompts`` and
    decodes its rows into its own cache; greedy picks the global argmax
    over the vocab blocks, ``sample`` gets the global logits on every rank
    (so draws the same tokens on each), and every rank returns the same
    global tokens, counted globally in tokens/s."""
    device = params["embed"].device
    B, prompt_len = prompts.shape
    total = prompt_len + max_new_tokens
    cache = tf.init_cache(cfg, B, total, cache_dtype or dtype, device, ctx)
    V = cfg.vocab_size
    out = torch.zeros((B, total), dtype=torch.int32, device=device)
    out[:, :prompt_len] = torch.as_tensor(np.asarray(prompts, np.int32),
                                          device=device)
    tok = out[:, :1]
    _sync(device)
    t0 = time.perf_counter()
    for pos in range(total - 1):
        logits, cache = tf.decode_step(params, cache, tok, pos, cfg, ctx)
        if pos + 1 < prompt_len:
            tok = out[:, pos + 1: pos + 2]
        else:
            if ctx.world is None:
                nxt = (torch.argmax(logits, dim=-1) if sample is None
                       else sample(logits))
            elif sample is None:
                nxt = global_argmax(logits, ctx, ("batch", "act_model"),
                                    (B, V))
            else:
                nxt = sample(gather_global(logits, ctx,
                                           ("batch", "act_model"), (B, V)))
            out[:, pos + 1] = nxt.to(torch.int32)
            tok = out[:, pos + 1: pos + 2]
    _sync(device)
    dt = time.perf_counter() - t0
    return GenerateResult(out.cpu().numpy(), B * (total - 1) / dt)


@dataclasses.dataclass
class FMQueryResult:
    """One answered request.  ``positions`` is None for count requests."""

    kind: str                       # "count" | "locate"
    count: int
    positions: np.ndarray | None = None


@dataclasses.dataclass
class FMServerStats:
    queries: int = 0
    batches: int = 0
    seconds: float = 0.0

    @property
    def qps(self) -> float:
        return self.queries / self.seconds if self.seconds else 0.0


class FMQueryServer:
    """Micro-batching FM-index query server over a built SequenceIndex.

    Mixed count/locate requests accumulate via ``submit`` and are answered
    by ``flush``: requests are grouped by (kind, length bucket), each group
    is PAD-padded to a fixed (power-of-two batch, length) shape, and one
    index call dispatches per bucket.  ``device`` (None = the GPU) must be
    where the index lives; without a GPU pass ``device="cpu"``.
    """

    def __init__(self, index, *, length_buckets=(8, 16, 32, 64),
                 max_batch: int = 256, locate_k: int = 16,
                 completed_cap: int = 1 << 16, device=None):
        dev = resolve_device(device)
        if index.device.type != dev.type:
            raise ValueError(f"index lives on {index.device}, server asked "
                             f"to serve on {dev}")
        self.index = index
        self.device = dev
        self.length_buckets = tuple(sorted(length_buckets))
        self.max_batch = max_batch
        self.locate_k = locate_k
        self._queue: list[tuple[int, str, np.ndarray, int]] = []
        self._next_ticket = 0
        # answered requests retained across flushes, oldest evicted beyond
        # ``completed_cap`` (dict order = ticket order)
        self.completed: dict[int, FMQueryResult] = {}
        self.completed_cap = completed_cap
        self.stats = FMServerStats()

    @classmethod
    def from_config(cls, index, cfg, *, device=None) -> "FMQueryServer":
        """Build from a BWTIndexConfig's serving knobs."""
        return cls(index, length_buckets=cfg.serve_length_buckets,
                   max_batch=cfg.serve_max_batch, locate_k=cfg.locate_k,
                   device=device)

    def _bucket_len(self, m: int) -> int:
        for b in self.length_buckets:
            if m <= b:
                return b
        b = self.length_buckets[-1]
        while b < m:  # oversize queries: next power-of-two bucket
            b *= 2
        return b

    def _bucket_batch(self, b: int) -> int:
        out = 1
        while out < b:
            out *= 2
        return min(out, self.max_batch)  # the configured cap wins over pow2

    def submit(self, pattern: np.ndarray, kind: str = "count",
               k: int | None = None) -> int:
        """Enqueue one query (a 1-D int sequence over the index alphabet,
        no PAD); returns its ticket.  ``k`` overrides the server's locate_k
        for this request only."""
        if kind not in ("count", "locate"):
            raise ValueError(f"unknown query kind {kind!r}")
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append(
            (t, kind, np.asarray(pattern, np.int32),
             self.locate_k if k is None else k)
        )
        return t

    def flush(self) -> dict[int, FMQueryResult]:
        """Answer every queued request; returns {ticket: result} for this
        flush (and records them in ``self.completed``).  Timed through the
        host copy of each bucket's answer, so the device work is done."""
        queue, self._queue = self._queue, []
        results: dict[int, FMQueryResult] = {}
        groups: dict[tuple[str, int, int], list[tuple[int, np.ndarray]]] = {}
        for t, kind, pat, k in queue:
            key = (kind, self._bucket_len(len(pat)),
                   k if kind == "locate" else 0)
            groups.setdefault(key, []).append((t, pat))
        t0 = time.perf_counter()
        for (kind, L, k), items in sorted(groups.items()):
            for lo in range(0, len(items), self.max_batch):
                chunk = items[lo: lo + self.max_batch]
                B = self._bucket_batch(len(chunk))
                pats = np.full((B, L), PAD, np.int32)
                for i, (_, pat) in enumerate(chunk):
                    pats[i, : len(pat)] = pat
                pats_t = torch.from_numpy(pats).to(self.device)
                if kind == "count":
                    counts = self.index.count(pats_t).cpu().numpy()
                    for i, (t, _) in enumerate(chunk):
                        results[t] = FMQueryResult("count", int(counts[i]))
                else:
                    pos, counts = self.index.locate(pats_t, k)
                    pos, counts = pos.cpu().numpy(), counts.cpu().numpy()
                    for i, (t, _) in enumerate(chunk):
                        c = int(counts[i])
                        results[t] = FMQueryResult(
                            "locate", c, pos[i, :c].copy()
                        )
                self.stats.batches += 1
        self.stats.seconds += time.perf_counter() - t0
        self.stats.queries += len(queue)
        self.completed.update(results)
        while len(self.completed) > self.completed_cap:
            self.completed.pop(next(iter(self.completed)))
        return results

    def count(self, queries: list[np.ndarray]) -> np.ndarray:
        """Batched exact-match counts for raw variable-length queries ->
        int64[len(queries)] (flushes the whole queue)."""
        tickets = [self.submit(q, "count") for q in queries]
        res = self.flush()
        return np.array([res[t].count for t in tickets], np.int64)

    def locate(self, queries: list[np.ndarray], k: int | None = None):
        """First-k occurrence positions per query (ascending, length =
        min(#occurrences, k))."""
        tickets = [self.submit(q, "locate", k=k) for q in queries]
        res = self.flush()
        return [res[t].positions for t in tickets]

    def throughput_report(self) -> str:
        s = self.stats
        return (
            f"fm-server: {s.queries} queries in {s.batches} batches, "
            f"{s.seconds * 1e3:.1f}ms -> {s.qps:.0f} queries/s"
        )
