"""Crash-safe generation commits for on-disk catalogs (a copy of the JAX
package's ``core/journal.py``: stdlib only, the same files on disk).

A ``SegmentedIndex`` catalog is a directory of immutable segment artifacts
plus one mutable description of which segments are live.  The pre-journal
``save`` deleted orphans and rewrote ``catalog.json`` with no ordering
guarantees — a crash mid-save could leave a catalog that references
deleted segments, or a half-written description.  This module makes every
catalog mutation a **two-phase generation commit**:

1. *Stage*: write every new artifact file (failpoints ``io.write``),
   fsync them (``io.fsync``), then write a **generation manifest**
   ``gen_<g>.json`` — the full catalog payload plus a CRC32 + size per
   live artifact file — and fsync it too.  Nothing written so far is
   referenced by the committed state; a crash anywhere in this phase
   leaves the previous generation fully intact.
2. *Commit*: atomically replace the ``CURRENT`` pointer file with the new
   generation's name (``io.rename`` failpoint, then ``os.replace`` —
   POSIX-atomic).  This single rename is the commit point.
3. *Garbage-collect* (only after commit): delete artifacts the committed
   generation no longer references, older generation manifests, and stray
   ``*.tmp`` staging files.

``committed()`` reads the pointer and validates the manifest it names,
rolling back through older on-disk generations if the pointed-to one is
torn (can only happen with a corrupted filesystem — the commit ordering
never produces it).  ``recover()`` removes everything a torn generation
staged, restoring the invariant that the directory holds exactly the
committed generation's files.  Readers verify artifact CRCs
(``restore.checksum`` failpoint) and quarantine — rather than serve —
anything that does not match.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

from ..testing.faultinject import checksum_fault, fault_point

CURRENT = "CURRENT"
GEN_PREFIX = "gen_"
GEN_FMT = GEN_PREFIX + "{:08d}.json"
QUARANTINE = "quarantine"


def crc32_path(path: str, chunk: int = 1 << 20) -> int:
    """Streaming CRC32 of a file (zlib polynomial, unsigned)."""
    crc = 0
    with open(path, "rb") as f:
        while block := f.read(chunk):
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def fsync_path(path: str) -> None:
    """fsync one file (failpoint ``io.fsync`` first)."""
    fault_point("io.fsync")
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync (durable rename on POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_file_durable(path: str, data: bytes) -> None:
    """Write ``path`` via a same-directory tmp + fsync + atomic rename.

    Failpoints: ``io.write`` before the write, ``io.fsync`` before the
    fsync, ``io.rename`` before the publishing rename — a crash at any of
    them leaves at most a ``*.tmp`` file, never a torn ``path``."""
    tmp = path + ".tmp"
    fault_point("io.write")
    with open(tmp, "wb") as f:
        f.write(data)
        fault_point("io.fsync")
        f.flush()
        os.fsync(f.fileno())
    fault_point("io.rename")
    os.replace(tmp, path)


def verify_file(base_dir: str, relpath: str, want: dict) -> str | None:
    """Why ``relpath`` fails verification against its manifest entry
    ``{"crc32", "size"}``, or None when it checks out.  The
    ``restore.checksum`` failpoint simulates a torn read: a hit reports a
    mismatch instead of raising."""
    path = os.path.join(base_dir, relpath)
    if not os.path.isfile(path):
        return "missing"
    size = os.path.getsize(path)
    if size != want["size"]:
        return f"size {size} != {want['size']}"
    if checksum_fault():
        return "checksum mismatch (injected)"
    crc = crc32_path(path)
    if crc != want["crc32"]:
        return f"crc32 {crc:#010x} != {want['crc32']:#010x}"
    return None


def manifest_entry(base_dir: str, relpath: str) -> dict:
    path = os.path.join(base_dir, relpath)
    return {"crc32": crc32_path(path), "size": os.path.getsize(path)}


class GenerationJournal:
    """The two-phase commit protocol over one catalog directory."""

    def __init__(self, directory: str):
        self.dir = directory

    # -- read side -----------------------------------------------------------

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.dir, GEN_FMT.format(gen))

    def on_disk_generations(self) -> list[int]:
        """Generation numbers with a manifest file present, ascending."""
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(GEN_PREFIX) and name.endswith(".json"):
                try:
                    out.append(int(name[len(GEN_PREFIX):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def _read_manifest(self, gen: int) -> dict | None:
        """The manifest of ``gen`` if it parses and self-identifies."""
        try:
            with open(self._gen_path(gen)) as f:
                man = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if man.get("generation") != gen or "files" not in man \
                or "catalog" not in man:
            return None
        return man

    def committed(self) -> dict | None:
        """The committed generation manifest (None: no journal here).

        Follows the ``CURRENT`` pointer; if the pointed-to manifest is
        unreadable (torn filesystem), rolls back to the newest older
        generation whose manifest parses."""
        cur = os.path.join(self.dir, CURRENT)
        gens = self.on_disk_generations()
        pointed = None
        try:
            with open(cur) as f:
                pointed = int(f.read().strip())
        except (OSError, ValueError):
            pointed = None
        candidates = []
        if pointed is not None:
            candidates.append(pointed)
        candidates += [g for g in reversed(gens)
                       if pointed is None or g < pointed]
        for gen in candidates:
            man = self._read_manifest(gen)
            if man is not None:
                return man
        return None

    # -- write side ----------------------------------------------------------

    def commit(self, catalog: dict, files: dict[str, dict]) -> dict:
        """Phase 2: publish a new generation.

        ``files`` maps artifact relpaths (already written AND fsynced by
        the caller) to ``{"crc32", "size"}`` entries.  Writes the
        generation manifest durably, then atomically flips ``CURRENT``.
        Returns the committed manifest."""
        prev = self.committed()
        gen = (prev["generation"] + 1) if prev else 0
        man = {"generation": gen, "catalog": catalog, "files": files}
        payload = json.dumps(man, indent=2).encode()
        write_file_durable(self._gen_path(gen), payload)
        # the commit point: one atomic pointer replace
        write_file_durable(os.path.join(self.dir, CURRENT),
                           f"{gen}\n".encode())
        fsync_dir(self.dir)
        return man

    def collect_garbage(self, keep_files) -> list[str]:
        """Post-commit / post-recovery sweep: delete stray ``*.tmp`` files,
        non-committed generation manifests, and any ``seg_*`` artifact
        path not in ``keep_files`` (an iterable of live relpaths).
        Returns the relpaths removed.  Never touches ``quarantine/``."""
        man = self.committed()
        keep_gen = man["generation"] if man else None
        keep = set(keep_files)
        removed = []
        for root, dirs, names in os.walk(self.dir, topdown=True):
            dirs[:] = [d for d in dirs if d != QUARANTINE]
            for name in names:
                rel = os.path.relpath(os.path.join(root, name), self.dir)
                if name.endswith(".tmp"):
                    removed.append(rel)
                elif name.startswith(GEN_PREFIX) and name.endswith(".json") \
                        and root == self.dir:
                    try:
                        g = int(name[len(GEN_PREFIX):-len(".json")])
                    except ValueError:
                        continue
                    if g != keep_gen:
                        removed.append(rel)
                elif rel.startswith("seg_") and rel not in keep:
                    removed.append(rel)
        for rel in removed:
            try:
                os.remove(os.path.join(self.dir, rel))
            except OSError:
                pass
        # prune now-empty segment directories left by file-level GC
        for root, dirs, names in os.walk(self.dir, topdown=False):
            base = os.path.basename(root)
            if base.startswith("seg_") or base.startswith("step_"):
                try:
                    os.rmdir(root)
                except OSError:
                    pass
        return removed

    def quarantine(self, relpath: str) -> str | None:
        """Move one artifact directory (or file) under ``quarantine/`` —
        corrupt data is withdrawn from serving but preserved for
        forensics.  Returns the new path (None if it vanished)."""
        src = os.path.join(self.dir, relpath)
        if not os.path.exists(src):
            return None
        qdir = os.path.join(self.dir, QUARANTINE)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, relpath.replace(os.sep, "__"))
        if os.path.exists(dst):
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            else:
                os.remove(dst)
        os.replace(src, dst)
        return dst
