"""Deterministic fault injection: named failpoints on the durability
paths, driven by an explicit (replayable) schedule.  A copy of the JAX
package's ``testing/faultinject.py`` (stdlib only), with the same failpoint
names and the same ``REPRO_FAULT_SCHEDULE`` grammar, so one schedule
drives either package.

The production code calls :func:`fault_point` at every place a crash or a
torn IO operation is interesting; when no schedule is armed the call is a
no-op costing one global read.  Tests arm a :class:`FaultSchedule` that
says *the k-th hit of failpoint NAME raises* — so a crash can be injected
at **every** site, one at a time, and replayed exactly: schedules are pure
data, hit counters are deterministic for a deterministic workload, and a
record-only schedule (no triggers) discovers how many times each failpoint
fires so a sweep can cover all of them.

Failpoint catalog (every name the reference defines; in this package
``training/checkpoint.py`` hits ``io.write`` and ``io.rename``,
``core/journal.py`` ``io.write``, ``io.fsync``, ``io.rename`` and
``restore.checksum``, ``core/bwt_merge.py`` ``merge.mid`` and
``merge.kway``, and ``serving/frontend.py`` ``worker.flush``):

=================  ==========================================================
``io.write``       before writing a durable artifact file (checkpoint
                   arrays/manifest, segment tokens, generation manifest)
``io.fsync``       before fsyncing a file that must be durable pre-commit
``io.rename``      before the atomic rename that publishes an artifact or
                   commits a generation
``merge.mid``      mid BWT-merge, after the interleave walk and before the
                   merged index exists
``merge.kway``     mid k-way merge only: after the chained multi-walker
                   walk, before the one-pass splice
``worker.flush``   inside the serving frontend's flush worker, outside its
                   recovery guards — simulates the worker thread dying
``restore.checksum`` while verifying an artifact checksum on restore — a
                   hit simulates the checksum coming back wrong (the reader
                   treats it as corruption, it does not propagate)
=================  ==========================================================

Scheduling grammar (``FaultSchedule.parse`` / ``--fault-schedule``):
``"io.write:2"`` fires on the third hit of ``io.write``;
``"io.write:0,io.rename:1"`` arms several independent triggers.  Each
trigger fires once (crash-then-recover semantics); hit counting continues
so a later trigger index still lines up.
"""

from __future__ import annotations

import contextlib
import os
import threading

FAILPOINTS = (
    "io.write",
    "io.fsync",
    "io.rename",
    "merge.mid",
    "merge.kway",
    "worker.flush",
    "restore.checksum",
)

ENV_VAR = "REPRO_FAULT_SCHEDULE"


class InjectedFault(RuntimeError):
    """Raised by an armed failpoint — the simulated crash."""


class FaultSchedule:
    """Which (failpoint, hit-index) pairs fire, plus deterministic counters.

    ``hits`` counts every time each failpoint was reached (fired or not);
    ``fired`` lists the (name, hit_index) pairs that actually raised.  A
    schedule with no triggers is a pure recorder — run the workload once
    under it to learn the hit counts, then sweep one trigger per hit.
    Thread-safe: the serving frontend's worker thread hits failpoints
    concurrently with the test thread.
    """

    def __init__(self, triggers=()):
        self._triggers: dict[str, set[int]] = {}
        for t in triggers:
            if isinstance(t, str):
                name, _, idx = t.partition(":")
                t = (name.strip(), int(idx))
            name, idx = t
            if name not in FAILPOINTS:
                raise ValueError(
                    f"unknown failpoint {name!r} (known: {FAILPOINTS})"
                )
            self._triggers.setdefault(name, set()).add(int(idx))
        self.hits: dict[str, int] = {}
        self.fired: list[tuple[str, int]] = []
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """``"name:k[,name:k...]"`` -> schedule (empty spec = recorder)."""
        parts = [p for p in (spec or "").split(",") if p.strip()]
        return cls(parts)

    def should_fire(self, name: str) -> bool:
        """Count one hit of ``name``; True when an armed trigger matches.
        Each trigger fires at most once."""
        with self._lock:
            k = self.hits.get(name, 0)
            self.hits[name] = k + 1
            armed = self._triggers.get(name)
            if armed and k in armed:
                armed.discard(k)
                self.fired.append((name, k))
                return True
            return False

    def report(self) -> dict:
        """JSON-able summary (hit counts + what fired) for demo output."""
        with self._lock:
            return {"hits": dict(self.hits), "fired": list(self.fired)}


_active: FaultSchedule | None = None
_arm_lock = threading.Lock()


def arm(schedule: FaultSchedule | None) -> FaultSchedule | None:
    """Persistently install ``schedule`` (None disarms); returns it."""
    global _active
    with _arm_lock:
        _active = schedule
    return schedule


def active() -> FaultSchedule | None:
    return _active


@contextlib.contextmanager
def inject(schedule: FaultSchedule):
    """Arm ``schedule`` for the duration of the block (restores the
    previous schedule on exit, even on the injected crash itself)."""
    global _active
    with _arm_lock:
        prev, _active = _active, schedule
    try:
        yield schedule
    finally:
        with _arm_lock:
            _active = prev


def fault_point(name: str) -> None:
    """Declare a failpoint.  No-op unless an armed schedule fires here."""
    s = _active
    if s is not None and s.should_fire(name):
        raise InjectedFault(f"injected fault at {name!r} "
                            f"(hit {s.hits[name] - 1})")


def checksum_fault(name: str = "restore.checksum") -> bool:
    """Failpoint variant for verification sites: True = pretend the check
    failed (simulated torn read), instead of raising."""
    s = _active
    return s is not None and s.should_fire(name)


def arm_from_env() -> FaultSchedule | None:
    """Arm from ``REPRO_FAULT_SCHEDULE`` (subprocess scenarios under CI);
    returns the armed schedule or None when the variable is unset/empty."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec.strip():
        return None
    return arm(FaultSchedule.parse(spec))
