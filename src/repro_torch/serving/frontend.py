"""Async serving frontend: an admission-controlled request queue in front
of ``FMQueryServer``, with max-batch/max-wait coalescing, per-bucket
latency SLO accounting and a self-healing fault model (the JAX package's
``serving/frontend.py``, same semantics and field names).

``FMQueryServer.flush`` is a synchronous call: whoever holds the thread
pays for the whole batch, there is no backpressure, and a traffic spike
just grows the Python queue.  This module is the serving layer in front of
it:

* ``submit`` is non-blocking and thread-safe; it returns a
  ``concurrent.futures.Future`` resolving to an ``FMQueryResult``.
* **Admission control**: the queue is bounded (``max_queue``); submits
  beyond the bound resolve immediately to a ``Rejected`` result: overload
  degrades by shedding load, never by stalling admitted work.
* **Deadlines**: ``submit(..., deadline_ms=...)`` bounds how long the
  caller will wait: a request whose deadline passes before its flush
  dispatches resolves to ``DeadlineExceeded``.
* A background worker coalesces admitted requests into flushes: it fires
  as soon as ``max_batch`` requests are waiting OR the oldest request has
  waited ``max_wait_ms``.
* **Per-bucket latency accounting**: every completed request records its
  enqueue-to-resolve latency under its bucket (kind + padded length);
  ``metrics()`` exports p50/p99 per bucket plus shed/throughput counters,
  checked against per-kind p99 SLO targets.
* **Live appends**: when the served index is a ``SegmentedIndex``,
  ``append`` enqueues an index-growth control op.  The flush worker (the
  single thread owning all index dispatches, so growth never races a
  query) applies it *between* flushes and then runs the background
  compaction policy (``maybe_compact``).

The frontend adds no device logic: the server's index answers on its own
device, and every launch comes from the worker thread (or, after
``stop()``, from the thread that drains inline).

Fault model:

* **Worker watchdog**: if the flush worker thread dies (a bug, an
  injected ``worker.flush`` fault), its supervisor fails ONLY the
  in-flight work's futures (with the crash exception), spawns a
  replacement worker, and the rest of the queue keeps serving.
  ``metrics()["worker_restarts"]`` counts the restarts.
* **Growth-op retry**: transient append/compaction failures retry with
  capped exponential backoff (``growth_retries`` / ``growth_backoff_ms``).
  Deterministic input errors (``ValueError``/``TypeError``) fail fast.
* **Poison-op quarantine**: a compaction that exhausts its retries is
  quarantined: the pre-compact generation keeps serving, later appends
  skip compaction until ``resume_compaction()``, and
  ``metrics()["quarantined_segments"]`` / ``["degraded"]`` surface it.
* ``stop()`` (alias ``close()``) always resolves every admitted future:
  the worker drains, and anything it never reached (including work
  stranded by a crash during shutdown) is drained inline.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..testing.faultinject import fault_point
from .engine import FMQueryServer


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Admission-control shed marker: the request was NOT answered.

    Returned (inside the future) instead of ``FMQueryResult`` when the
    queue is at ``max_queue`` depth.  Clients retry with backoff or drop.
    """

    kind: str                   # "count" | "locate" — mirrors the request
    reason: str = "queue_full"


@dataclasses.dataclass(frozen=True)
class DeadlineExceeded:
    """The request was admitted but its deadline passed before its flush
    dispatched — resolved instead of leaving the caller waiting forever."""

    kind: str                   # "count" | "locate" — mirrors the request
    reason: str = "deadline"


@dataclasses.dataclass(frozen=True)
class Shutdown:
    """The frontend stopped before this admitted request could dispatch
    and the shutdown drain could not answer it."""

    kind: str
    reason: str = "shutdown"


@dataclasses.dataclass
class _BucketStats:
    """Latency accounting for one bucket (kind, padded length)."""

    slo_p99_ms: float | None
    window: dataclasses.InitVar[int] = 4096
    completed: int = 0
    violations: int = 0         # individual latencies over the SLO target
    latencies_ms: deque = None

    def __post_init__(self, window):
        self.latencies_ms = deque(maxlen=window)

    def record(self, lat_ms: float) -> None:
        self.completed += 1
        self.latencies_ms.append(lat_ms)
        if self.slo_p99_ms is not None and lat_ms > self.slo_p99_ms:
            self.violations += 1

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_ms, np.float64)
        p50 = float(np.percentile(lat, 50)) if lat.size else 0.0
        p99 = float(np.percentile(lat, 99)) if lat.size else 0.0
        out = {
            "completed": self.completed,
            "p50_ms": p50,
            "p99_ms": p99,
            "slo_p99_ms": self.slo_p99_ms,
            "slo_ok": (p99 <= self.slo_p99_ms
                       if self.slo_p99_ms is not None and lat.size else None),
            "violations": self.violations,
        }
        return out


# queue entry: (t_enqueue, pattern, kind, k, future, abs_deadline | None)
_FUT = 4
_DEADLINE = 5


class AsyncQueryFrontend:
    """Admission-controlled, self-healing async frontend over an
    ``FMQueryServer``.

        server = FMQueryServer(index)
        with AsyncQueryFrontend(server, max_queue=4096) as fe:
            fut = fe.submit(pattern, "count", deadline_ms=250)
            ...
            res = fut.result()   # FMQueryResult | Rejected | DeadlineExceeded
            print(fe.metrics())

    One background worker owns all index dispatches (device calls never
    race);
    producers only touch the bounded queue under a lock.  A supervisor
    restarts the worker if it crashes, failing only the crashed flush's
    futures.  ``stop()``/``close()`` (or leaving the ``with`` block)
    resolves every admitted future before returning.
    """

    def __init__(self, server: FMQueryServer, *, max_queue: int = 8192,
                 max_wait_ms: float = 2.0, max_batch: int | None = None,
                 slo_p99_ms: dict[str, float] | None = None,
                 window: int = 4096, autostart: bool = True,
                 growth_retries: int = 3, growth_backoff_ms: float = 5.0,
                 growth_backoff_cap_ms: float = 80.0):
        self.server = server
        self.max_queue = max_queue
        self.max_wait_s = max_wait_ms / 1e3
        self.max_batch = server.max_batch if max_batch is None else max_batch
        self.slo_p99_ms = dict(slo_p99_ms or {})  # per kind: {"count": ms}
        self.window = window
        self.growth_retries = growth_retries
        self.growth_backoff_ms = growth_backoff_ms
        self.growth_backoff_cap_ms = growth_backoff_cap_ms
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # entries appended under the lock only; layout per _FUT/_DEADLINE
        self._pending: deque = deque()
        # (tokens, future) index-growth ops, drained before each flush
        self._control: deque = deque()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._inflight = None       # work the worker is dispatching now
        self._t_start = time.perf_counter()
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.flushes = 0
        self.appends = 0
        self.compactions = 0
        # fault counters (exported by metrics())
        self.worker_restarts = 0
        self.retries = 0
        self.quarantined_segments = 0
        self.deadline_exceeded = 0
        self._compaction_quarantined = False
        self._buckets: dict[str, _BucketStats] = {}
        if autostart:
            self.start()

    @classmethod
    def from_config(cls, server: FMQueryServer, cfg,
                    **kw) -> "AsyncQueryFrontend":
        """Build from a BWTIndexConfig's frontend knobs."""
        kw.setdefault("max_queue", cfg.serve_queue_depth)
        kw.setdefault("max_wait_ms", cfg.serve_max_wait_ms)
        kw.setdefault("slo_p99_ms", {"count": cfg.serve_slo_p99_ms,
                                     "locate": cfg.serve_slo_p99_ms_locate})
        kw.setdefault("growth_retries", cfg.serve_growth_retries)
        kw.setdefault("growth_backoff_ms", cfg.serve_growth_backoff_ms)
        return cls(server, **kw)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the flush worker (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = self._spawn_worker()

    def _spawn_worker(self) -> threading.Thread:
        t = threading.Thread(
            target=self._worker_main, name="fm-frontend-flush", daemon=True
        )
        t.start()
        return t

    def stop(self) -> None:
        """Resolve every admitted future, then stop the worker.

        The worker drains the queue; anything it never reached — never
        started, crashed mid-shutdown, or enqueued in a race with stop —
        is drained inline, so an admitted future can never hang across a
        close."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        self._drain_inline()

    #: ``close()`` is the conventional name; identical semantics.
    close = stop

    def __enter__(self) -> "AsyncQueryFrontend":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- producer side -------------------------------------------------------

    def submit(self, pattern, kind: str = "count", k: int | None = None,
               deadline_ms: float | None = None) -> Future:
        """Enqueue one query; never blocks on the index.

        Returns a future resolving to ``FMQueryResult`` (admitted),
        ``Rejected`` (queue at ``max_queue`` — already resolved on
        return), or ``DeadlineExceeded`` (admitted, but ``deadline_ms``
        elapsed before its flush dispatched).  ``pattern``/``kind``/``k``
        as in ``FMQueryServer.submit``."""
        if kind not in ("count", "locate"):
            raise ValueError(f"unknown query kind {kind!r}")
        if deadline_ms is not None and deadline_ms < 0:
            raise ValueError(f"negative deadline_ms {deadline_ms}")
        fut: Future = Future()
        pat = np.asarray(pattern, np.int32)
        t0 = time.perf_counter()
        deadline = None if deadline_ms is None else t0 + deadline_ms / 1e3
        with self._cond:
            if self._stop:
                raise RuntimeError("frontend is stopped")
            if len(self._pending) >= self.max_queue:
                self.rejected += 1
                fut.set_result(Rejected(kind))
                return fut
            self.admitted += 1
            self._pending.append((t0, pat, kind, k, fut, deadline))
            self._cond.notify()
        return fut

    def append(self, tokens) -> Future:
        """Grow the served ``SegmentedIndex`` without stopping the frontend.

        Enqueues an index-growth control op; the flush worker applies it
        between flushes (appends a segment, then runs the background
        compaction policy — ``SegmentedIndex.maybe_compact``, rebuild-free
        BWT merge by default).  Transient failures retry with capped
        exponential backoff; a compaction that keeps failing is
        quarantined (the pre-compact generation keeps serving).  Returns a
        future resolving to a summary dict {"appended", "merges",
        "segments", "total_tokens", "compaction_quarantined"}.  Queries
        admitted after the future resolves see the new text.  Control ops
        are never shed (they carry corpus data, not load).
        """
        if not hasattr(self.server.index, "append"):
            raise TypeError(
                f"served index {type(self.server.index).__name__} does not "
                "support append (serve a SegmentedIndex)"
            )
        fut: Future = Future()
        toks = np.asarray(tokens, np.int32)
        with self._cond:
            if self._stop:
                raise RuntimeError("frontend is stopped")
            self._control.append((toks, fut))
            self._cond.notify()
        return fut

    def resume_compaction(self) -> None:
        """Lift a poison-op quarantine: later appends run the background
        compaction policy again (e.g. after the faulty input or disk
        condition was repaired)."""
        with self._lock:
            self._compaction_quarantined = False

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- worker side ---------------------------------------------------------

    def _take_work(self):
        """Block until there is work: ("ctrl", ops) for pending index
        growth (always drained before the next flush), ("batch", requests)
        once max-batch/max-wait coalescing trips, None = stopped and
        drained."""
        with self._cond:
            while (not self._pending and not self._control
                   and not self._stop):
                self._cond.wait()
            if self._control:
                ctrl = list(self._control)
                self._control.clear()
                return "ctrl", ctrl
            if not self._pending:
                return None                   # stopping, nothing left
            while (len(self._pending) < self.max_batch and not self._stop
                   and not self._control):    # appends cut coalescing short
                oldest = self._pending[0][0]
                remaining = oldest + self.max_wait_s - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch = list(self._pending)
            self._pending.clear()
            return "batch", batch

    def _worker_main(self) -> None:
        """The worker's supervisor: runs the flush loop; on a crash (an
        exception escaping the loop's per-work guards) fails ONLY the
        in-flight work's futures, then spawns a replacement worker —
        queued-but-undispatched requests survive the crash untouched."""
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 — the watchdog path
            inflight, self._inflight = self._inflight, None
            if inflight is not None:
                futs = [(item[1] if inflight[0] == "ctrl" else item[_FUT])
                        for item in inflight[1]]
                for fut in futs:
                    try:
                        if not fut.done():
                            fut.set_exception(e)
                    except InvalidStateError:
                        pass  # lost a race with a client cancel()
            with self._cond:
                self.worker_restarts += 1
                if not self._stop and self._thread is \
                        threading.current_thread():
                    self._thread = self._spawn_worker()

    def _run(self) -> None:
        while True:
            work = self._take_work()
            if work is None:
                return
            self._inflight = work
            kind, items = work
            if kind == "ctrl":
                self._apply_controls(items)
            else:
                self._flush_batch(items)
            self._inflight = None

    def _with_retries(self, fn):
        """Run a growth op, retrying transient failures with capped
        exponential backoff.  Deterministic input errors (ValueError /
        TypeError) are not transient and fail immediately."""
        delay = self.growth_backoff_ms / 1e3
        attempt = 0
        while True:
            try:
                return fn()
            except (ValueError, TypeError):
                raise
            except Exception:
                if attempt >= self.growth_retries:
                    raise
                attempt += 1
                with self._lock:
                    self.retries += 1
                time.sleep(delay)
                delay = min(delay * 2, self.growth_backoff_cap_ms / 1e3)

    def _apply_controls(self, ctrl: list) -> None:
        """Apply index-growth ops on the worker thread (the only thread
        dispatching into the index, so growth cannot race a flush)."""
        for toks, fut in ctrl:
            if not fut.set_running_or_notify_cancel():
                continue
            index = self.server.index
            try:
                seg = self._with_retries(lambda: index.append(toks))
            except Exception as e:  # noqa: BLE001 — worker must survive
                fut.set_exception(e)
                continue
            # compaction failure must not lose the append: it is retried
            # independently, and a poison op quarantines — the pre-compact
            # generation keeps serving and later appends skip compaction
            merges = 0
            compact_error = None
            if not self._compaction_quarantined:
                try:
                    merges = self._with_retries(index.maybe_compact)
                except Exception as e:  # noqa: BLE001
                    compact_error = repr(e)
                    with self._lock:
                        self._compaction_quarantined = True
                        self.quarantined_segments += 1
            out = {
                "appended": int(seg.n_tokens), "merges": int(merges),
                "segments": len(index.segments),
                "total_tokens": int(index.total_tokens),
                "compaction_quarantined": self._compaction_quarantined,
            }
            if compact_error:
                out["compaction_error"] = compact_error
            with self._lock:
                self.appends += 1
                self.compactions += merges
            fut.set_result(out)

    def _drain_inline(self) -> None:
        while True:
            with self._cond:
                ctrl = list(self._control)
                self._control.clear()
                batch = list(self._pending)
                self._pending.clear()
            if not ctrl and not batch:
                return
            if ctrl:
                self._apply_controls(ctrl)
            if batch:
                try:
                    self._flush_batch(batch)
                except BaseException:  # noqa: BLE001 — resolve, not hang
                    for e in batch:
                        try:
                            if not e[_FUT].done():
                                e[_FUT].set_result(Shutdown(e[2]))
                        except InvalidStateError:
                            pass

    def _flush_batch(self, batch: list) -> None:
        # the injected worker-crash site: OUTSIDE every recovery guard, so
        # the exception kills the worker thread and exercises the watchdog
        fault_point("worker.flush")
        # claim every future before dispatch: a client cancel() between
        # admission and flush drops the request here; once claimed,
        # set_result can no longer race a cancel and kill the worker
        batch = [e for e in batch if e[_FUT].set_running_or_notify_cancel()]
        # expire deadlines at dispatch time: the caller stops waiting NOW
        # instead of paying for a flush it no longer wants
        now = time.perf_counter()
        expired = [e for e in batch
                   if e[_DEADLINE] is not None and now > e[_DEADLINE]]
        if expired:
            batch = [e for e in batch if e[_DEADLINE] is None
                     or now <= e[_DEADLINE]]
            with self._lock:
                self.deadline_exceeded += len(expired)
            for e in expired:
                e[_FUT].set_result(DeadlineExceeded(e[2]))
        if not batch:
            return
        try:
            # the whole dispatch is guarded: the single worker thread must
            # survive ANY failure (bad pattern, a foreign flush of the
            # shared server stealing tickets, ...) — an admitted future
            # must resolve, if only to an exception
            tickets = [
                self.server.submit(pat, kind, k=k)
                for (_, pat, kind, k, _, _) in batch
            ]
            results = self.server.flush()
            outs = [results[t] for t in tickets]
        except Exception as e:  # noqa: BLE001 — the worker must survive
            for e_ in batch:
                if not e_[_FUT].done():
                    e_[_FUT].set_exception(e)
            return
        t_done = time.perf_counter()
        with self._lock:
            self.flushes += 1
            self.completed += len(batch)
            for (t0, pat, kind, _, _, _) in batch:
                self._bucket(kind, len(pat)).record((t_done - t0) * 1e3)
        for out, e in zip(outs, batch):
            e[_FUT].set_result(out)

    def _bucket(self, kind: str, m: int) -> _BucketStats:
        key = f"{kind}/{self.server._bucket_len(m)}"
        if key not in self._buckets:
            self._buckets[key] = _BucketStats(
                self.slo_p99_ms.get(kind), self.window
            )
        return self._buckets[key]

    # -- observability -------------------------------------------------------

    def metrics(self) -> dict:
        """Serving metrics snapshot (JSON-able).

        ``buckets`` maps "kind/padded-length" (one per padded shape the
        server dispatched) to {completed, p50_ms, p99_ms, slo_p99_ms, slo_ok,
        violations} over the last ``window`` completions; top level carries
        admitted/rejected/completed counters, the shed fraction, sustained
        qps since start, the live queue depth, and the fault counters
        (worker_restarts, retries, quarantined_segments, deadline_exceeded,
        degraded — the latter true when the served index came up with
        quarantined segments or compaction is poison-quarantined)."""
        with self._lock:
            offered = self.admitted + self.rejected
            elapsed = time.perf_counter() - self._t_start
            degraded = bool(getattr(self.server.index, "degraded", False)
                            or self._compaction_quarantined)
            return {
                "admitted": self.admitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "flushes": self.flushes,
                "appends": self.appends,
                "compactions": self.compactions,
                "shed_frac": self.rejected / offered if offered else 0.0,
                "qps": self.completed / elapsed if elapsed > 0 else 0.0,
                "queue_depth": len(self._pending),
                "max_queue": self.max_queue,
                "worker_restarts": self.worker_restarts,
                "retries": self.retries,
                "quarantined_segments": self.quarantined_segments,
                "deadline_exceeded": self.deadline_exceeded,
                "degraded": degraded,
                # compaction planner telemetry (SegmentedIndex; zero/empty
                # for monolithic indexes): merge-strategy runs that fell
                # back to the O(n log n) rebuild, why the last one did,
                # and how often each strategy actually ran
                "compact_fallbacks": int(getattr(
                    self.server.index, "compact_fallbacks", 0)),
                "compact_last_fallback_reason": getattr(
                    self.server.index, "compact_last_fallback_reason", None),
                "compact_strategy_counts": dict(getattr(
                    self.server.index, "compact_strategy_counts", {}) or {}),
                "buckets": {
                    key: b.summary()
                    for key, b in sorted(self._buckets.items())
                },
            }
