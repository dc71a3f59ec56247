"""Index lifecycle IO: versioned checkpoint/restore of built FM indexes,
in the JAX package's format (``core/index_io.py`` there): the same npz
keys, dtypes and shapes, the same ``meta.json`` manifest and the same
``step_%08d`` directories, so a checkpoint written by either package
restores in the other.

On-disk layout (one ``Checkpointer`` step directory per saved index):

    ckpt_dir/step_00000000/
      arrays.npz      bwt, row, SA-sample bitvector + packed/raw values,
                      plus the derived single-device layout (c_array,
                      occ_samples, fused rows)
      meta.json       manifest: format/version, kind, static aux (sigma,
                      sample_rate, bits, sa_sample_rate, sa_val_bits, ...)

Restore has the reference's two single-device branches: a pure
reconstruction from the stored layout, or, for a checkpoint that does not
store it (the reference's sharded ``dist_fm`` kind), ``build_fm_index``
over the stored BWT on the target device.  Saving a distributed index and
restoring onto a mesh are not ported yet.
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
from .dist_fm import DistFMIndex
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


def _manifest(fm: FMIndex, text_length: int) -> dict:
    return {
        "format": FORMAT,
        "version": VERSION,
        "kind": "fm",
        "sample_rate": fm.sample_rate,
        "sigma": fm.sigma,
        "length": fm.length,
        "bits": fm.bits,
        "sa_sample_rate": fm.sa_sample_rate,
        "sa_val_bits": fm.sa_val_bits,
        "text_length": text_length,
        "built_parts": 1,  # informational only
    }


def save_index(directory: str, index, *, step: int = 0, keep: int = 3) -> int:
    """Checkpoint a built index (a ``SequenceIndex`` or a bare
    ``FMIndex``); returns the step written.  Arrays are copied to the host
    before writing.  Atomic: a crash mid-save never corrupts the previous
    step; ``keep`` steps are retained."""
    fm = index.fm if isinstance(index, SequenceIndex) else index
    if isinstance(fm, DistFMIndex):
        raise NotImplementedError(
            "saving a distributed index is not ported yet (ROADMAP A10b); "
            "save a single-device build")
    text_length = (
        index.text_length if isinstance(index, SequenceIndex) else fm.length
    )
    # the derived layout is cheap to store and makes restore a pure
    # reconstruction (no recompute at all); fused is None when unpacked
    names = _COMMON + (_SA_ARRAYS if fm.sa_sample_rate else ()) + _FM_LAYOUT
    tree = {name: getattr(fm, name) for name in names
            if getattr(fm, name) is not None}
    manifest = _manifest(fm, text_length)
    manifest["arrays"] = sorted(tree)
    Checkpointer(directory, keep=keep).save(step, tree, extra=manifest)
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
    bit-identical to the index that was saved.  ``mesh`` (a sharded
    restore) is not ported yet and raises."""
    if mesh is not None:
        raise NotImplementedError("restoring onto a mesh is not ported yet; "
                                  "pass mesh=None")
    dev = resolve_device(device)
    flat, meta = _load_raw(directory, step)
    sample_rate = meta["sample_rate"]
    sigma = meta["sigma"]
    srate = meta["sa_sample_rate"]

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    row = put(flat["row"])
    sa_samples = None
    if srate:
        sa_samples = tuple(put(flat[k]) for k in _SA_ARRAYS) + (
            meta["sa_val_bits"],)

    if meta["kind"] == "fm" and "occ_samples" in flat:
        # pure reconstruction from the stored layout
        fm = FMIndex(
            put(flat["bwt"]), row, put(flat["c_array"]),
            put(flat["occ_samples"]),
            put(flat["fused"]) if "fused" in flat else None,
            *(sa_samples[:3] if sa_samples else (None, None, None)),
            sample_rate, sigma, meta["length"], meta["bits"],
            srate, meta["sa_val_bits"],
        )
    else:  # no stored single-device layout: derive it on the device
        fm = build_fm_index(
            put(flat["bwt"][: meta["length"]]), row, sigma, sample_rate,
            pack=bool(meta["bits"]), sa_samples=sa_samples,
            sa_sample_rate=srate,
        )
    return SequenceIndex(fm, None, fm.bwt, row, sigma, meta["length"],
                         meta["text_length"])


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
