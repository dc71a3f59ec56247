"""Index lifecycle IO: versioned checkpoint/restore of built FM indexes,
in the JAX package's format (``core/index_io.py`` there): the same npz
keys, dtypes and shapes, the same ``meta.json`` manifest and the same
``step_%08d`` directories, so a checkpoint written by either package
restores in the other.

On-disk layout (one ``Checkpointer`` step directory per saved index):

    ckpt_dir/step_00000000/
      arrays.npz      bwt (global, padded), row, SA-sample bitvector +
                      packed/raw values, plus, for a single-device index,
                      the derived layout (c_array, occ_samples, fused rows)
      meta.json       manifest: format/version, kind ("fm" / "dist_fm"),
                      static aux (sigma, sample_rate, bits, sa_sample_rate,
                      sa_val_bits, built_parts, ...)

A distributed index (``core/dist_fm.py``, one rank's part per process)
saves as one global BWT: the ranks' shards are gathered to rank 0, which
writes; no per-shard layout is stored, since it depends on the number of
ranks.  Restore takes any mesh: each rank slices its shard of the stored
BWT and ``build_dist_fm_index`` recomputes the layout, so a checkpoint
written from 8 ranks serves from 4 or 1, and one written by a single
device serves from a mesh.  Without a mesh, restore is a pure
reconstruction from the stored layout, or ``build_fm_index`` over the
stored BWT when the checkpoint stores none (``"dist_fm"``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile

import numpy as np
import torch

from ..devices import resolve_device
from ..training.checkpoint import Checkpointer
from .dist_fm import DistFMIndex, build_dist_fm_index
from .dist_sort import _me, gather, mesh_parts, pmax, shard_info
from .fm_index import FMIndex, build_fm_index
from .pipeline import SequenceIndex

FORMAT = "fm_index_ckpt"
VERSION = 1

# arrays every kind stores / arrays only the single-device layout stores
_COMMON = ("bwt", "row")
_SA_ARRAYS = ("sa_marks", "sa_mark_ranks", "sa_vals")
_FM_LAYOUT = ("c_array", "occ_samples", "fused")


class IndexIOError(Exception):
    """Base for typed index checkpoint errors.  Every subclass also
    derives from the stdlib exception a pre-typed caller would have seen
    (``FileNotFoundError`` / ``ValueError``), so existing handlers keep
    working while new callers can catch the whole family at once."""


class MissingCheckpointError(IndexIOError, FileNotFoundError):
    """No checkpoint where one was expected (empty dir, missing manifest
    or arrays file).  Actionable: point at a directory ``save_index``
    wrote, or rebuild and save the index."""


class CorruptCheckpointError(IndexIOError, ValueError):
    """The checkpoint exists but cannot be trusted: unreadable/truncated
    arrays, a manifest that is not an index manifest, or arrays
    inconsistent with the manifest.  Actionable: restore an earlier
    ``step`` (``save_index`` keeps ``keep`` of them) or rebuild."""


class UnsupportedVersionError(IndexIOError, ValueError):
    """Checkpoint written by a newer format revision.  Actionable:
    upgrade this build; the artifact itself is healthy."""


def _manifest(fm, text_length: int) -> dict:
    return {
        "format": FORMAT,
        "version": VERSION,
        "kind": "dist_fm" if isinstance(fm, DistFMIndex) else "fm",
        "sample_rate": fm.sample_rate,
        "sigma": fm.sigma,
        "length": fm.length,
        "bits": fm.bits,
        "sa_sample_rate": fm.sa_sample_rate,
        "sa_val_bits": fm.sa_val_bits,
        "text_length": text_length,
        "built_parts": getattr(fm, "parts", 1),  # informational only
    }


def _write(directory: str, fm, tree: dict, text_length: int, step: int,
           keep: int) -> None:
    manifest = _manifest(fm, text_length)
    manifest["arrays"] = sorted(tree)
    Checkpointer(directory, keep=keep).save(step, tree, extra=manifest)


def save_index(directory: str, index, *, step: int = 0, keep: int = 3) -> int:
    """Checkpoint a built index (a ``SequenceIndex``, on one device or on
    a mesh, or a bare ``FMIndex``); returns the step written.  Arrays are
    copied to the host before writing.  Atomic: a crash mid-save never
    corrupts the previous step; ``keep`` steps are retained.

    A distributed index is saved by every rank of its mesh, making the
    same call: the BWT shards are gathered to rank 0, which writes, and
    every rank then learns the write's outcome in one collective (the
    barrier, under the world's timeout).  A failed write raises on every
    rank: the writer's own error on rank 0, ``RuntimeError`` elsewhere."""
    fm = index.fm if isinstance(index, SequenceIndex) else index
    text_length = (
        index.text_length if isinstance(index, SequenceIndex) else fm.length
    )
    sa_names = _SA_ARRAYS if fm.sa_sample_rate else ()
    if isinstance(fm, DistFMIndex):
        if not isinstance(index, SequenceIndex):
            raise TypeError("save a distributed index as the SequenceIndex "
                            "of its mesh build (it knows the mesh)")
        info = shard_info(index.mesh, fm.length)
        bwt = gather(info, fm.bwt)          # rank 0's; None elsewhere
        error = None
        if bwt is not None:
            tree = {"bwt": bwt.reshape(-1), "row": fm.row}
            tree.update({name: getattr(fm, name) for name in sa_names})
            try:
                _write(directory, fm, tree, text_length, step, keep)
            except Exception as e:          # raised after the barrier
                error = e
        failed = pmax(info, torch.tensor(error is not None,
                                         device=fm.device))
        if error is not None:
            raise error
        if bool(failed):
            raise RuntimeError(f"rank 0 failed to write index checkpoint "
                               f"step {step} under {directory!r}")
        return step
    # the derived layout is cheap to store and makes restore a pure
    # reconstruction (no recompute at all); fused is None when unpacked
    tree = {name: getattr(fm, name) for name in _COMMON + sa_names
            + _FM_LAYOUT if getattr(fm, name) is not None}
    _write(directory, fm, tree, text_length, step, keep)
    return step


def _check_manifest(meta: dict) -> None:
    if meta.get("format") != FORMAT:
        raise CorruptCheckpointError(
            f"not an index checkpoint (format={meta.get('format')!r})"
        )
    if meta.get("version", 0) > VERSION:
        raise UnsupportedVersionError(
            f"index checkpoint version {meta['version']} is newer than this "
            f"build supports ({VERSION}); upgrade the reader — the artifact "
            "itself is fine"
        )


def _load_raw(directory: str, step: int | None):
    """``Checkpointer.restore_raw`` with untyped filesystem/zip failures
    mapped to the typed error family, plus array-vs-manifest validation
    (missing leaves, truncated ``bwt``)."""
    try:
        flat, meta = Checkpointer(directory).restore_raw(step)
    except FileNotFoundError as e:
        raise MissingCheckpointError(
            f"no readable index checkpoint under {directory!r}: {e}. "
            "Expected a step directory with meta.json + arrays.npz "
            "(written by save_index)."
        ) from e
    except (zipfile.BadZipFile, json.JSONDecodeError, OSError,
            KeyError) as e:
        raise CorruptCheckpointError(
            f"index checkpoint under {directory!r} is unreadable ({e}); "
            "restore an earlier step or rebuild the index"
        ) from e
    _check_manifest(meta)
    declared = meta.get("arrays")
    if declared:
        missing = sorted(set(declared) - set(flat))
        if missing:
            raise CorruptCheckpointError(
                f"index checkpoint under {directory!r} is missing arrays "
                f"{missing} declared by its manifest; restore an earlier "
                "step or rebuild the index"
            )
    if "bwt" in flat and flat["bwt"].shape[0] < meta.get("length", 0):
        raise CorruptCheckpointError(
            f"index checkpoint under {directory!r} has a truncated bwt "
            f"({flat['bwt'].shape[0]} < manifest length {meta['length']}); "
            "restore an earlier step or rebuild the index"
        )
    return flat, meta


def restore_index(directory: str, mesh=None, *, step: int | None = None,
                  device=None) -> SequenceIndex:
    """Restore a checkpointed index onto ``device`` (None = the GPU),
    ready to serve.  Counting/locating on the restored index is
    bit-identical to the index that was saved.

    ``mesh`` (``launch/mesh.py`` ``make_index_mesh``; every rank of it
    makes the same call) restores a distributed index over its
    ``"parts"`` dimension from either kind of checkpoint, whatever mesh
    wrote it: each rank reads the checkpoint, slices its shard of the
    BWT and rebuilds its layout.  Raises ``ValueError`` when the padded
    length does not divide ``parts * sample_rate`` (pick another mesh, or
    restore on one device)."""
    dev = resolve_device(device)
    parts = None if mesh is None else mesh_parts(mesh)
    flat, meta = _load_raw(directory, step)
    sample_rate = meta["sample_rate"]
    sigma = meta["sigma"]
    srate = meta["sa_sample_rate"]
    n = meta["length"]

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    row = put(flat["row"])
    sa_samples = None
    if srate:
        sa_samples = tuple(put(flat[k]) for k in _SA_ARRAYS) + (
            meta["sa_val_bits"],)

    if mesh is not None:
        if n % parts or (n // parts) % sample_rate:
            raise ValueError(f"n={n} must be divisible by parts*sample_rate="
                             f"{parts}*{sample_rate}")
        m = n // parts
        me = _me(shard_info(mesh, n))
        fm = build_dist_fm_index(
            put(flat["bwt"][me * m: (me + 1) * m]), row, mesh, sigma=sigma,
            sample_rate=sample_rate, pack=bool(meta["bits"]),
            sa_samples=sa_samples, sa_sample_rate=srate,
        )
    elif meta["kind"] == "fm" and "occ_samples" in flat:
        # pure reconstruction from the stored layout
        fm = FMIndex(
            put(flat["bwt"]), row, put(flat["c_array"]),
            put(flat["occ_samples"]),
            put(flat["fused"]) if "fused" in flat else None,
            *(sa_samples[:3] if sa_samples else (None, None, None)),
            sample_rate, sigma, n, meta["bits"],
            srate, meta["sa_val_bits"],
        )
    else:  # no stored single-device layout: derive it on the device
        fm = build_fm_index(
            put(flat["bwt"][:n]), row, sigma, sample_rate,
            pack=bool(meta["bits"]), sa_samples=sa_samples,
            sa_sample_rate=srate,
        )
    return SequenceIndex(fm, None, fm.bwt, fm.row, sigma, n,
                         meta["text_length"], mesh=mesh)


def latest_index_step(directory: str) -> int | None:
    """Newest saved step under ``directory`` (None when empty): the serve
    launcher's save-step decision."""
    return Checkpointer(directory).latest_step()


@dataclasses.dataclass(frozen=True)
class IndexInfo:
    """Human-readable summary of a checkpointed index (``describe_index``)."""

    kind: str
    step: int
    sigma: int
    length: int
    text_length: int
    sample_rate: int
    bits: int
    sa_sample_rate: int
    sa_val_bits: int


def describe_index(directory: str, step: int | None = None) -> IndexInfo:
    """Read just the manifest of a saved index (no array IO)."""
    if step is None:
        step = Checkpointer(directory).latest_step()
        if step is None:
            raise MissingCheckpointError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "meta.json")
    try:
        with open(path) as f:
            meta = json.load(f)
    except FileNotFoundError as e:
        raise MissingCheckpointError(
            f"checkpoint step {step} under {directory!r} has no manifest "
            f"({path} is missing) — the save was torn; restore an earlier "
            "step or re-save"
        ) from e
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(
            f"manifest {path!r} is unreadable ({e}); restore an earlier "
            "step or rebuild"
        ) from e
    _check_manifest(meta)
    return IndexInfo(
        meta["kind"], step, meta["sigma"], meta["length"],
        meta["text_length"], meta["sample_rate"], meta["bits"],
        meta["sa_sample_rate"], meta["sa_val_bits"],
    )
