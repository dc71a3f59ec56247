"""Checkpointing: atomic, async, keep-k, in the JAX package's on-disk
format (``training/checkpoint.py`` there), so either package reads what
the other wrote.

Layout (one directory per step, atomically renamed into place):

    ckpt_dir/
      step_000123/
        arrays.npz          flattened leaves by joined key path
        meta.json           step + the caller's extra metadata

  * atomic   — write to ``step_X.tmp`` then ``os.rename`` (POSIX atomic);
               a crash mid-save never corrupts the latest checkpoint.
  * async    — ``save_async`` copies the tensors to the host on the caller
               thread (the snapshot) and does the file IO on a background
               thread.
  * keep-k   — old steps garbage-collected after a successful save.
  * host     — arrays are saved as host numpy arrays whatever device they
               came from; restore hands back numpy and the caller places
               them.

  * elastic  — arrays are saved unsharded (a sharded state is gathered
               before ``save``); ``restore(tree_like, shardings=...)``
               hands each rank of a mesh its slice, so a state saved
               from 8 ranks restores onto 4 unchanged.

``restore`` fills the structure of a template tree; ``restore_raw``
serves callers that rebuild typed objects from a manifest
(``core/index_io.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..core.dist_sort import _me, shard_info
from ..testing.faultinject import fault_point

_SEP = "/"


def _host(leaf, copy: bool = False) -> np.ndarray:
    """``leaf`` as a host array; with ``copy`` always a copy of its own
    (a CPU tensor's ``.cpu()`` is the live storage, which an in-place
    update would go on writing)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            t = t.float()        # npz-safe, as the reference stores bf16
        return t.numpy()
    arr = np.array(leaf, copy=True) if copy else np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree, prefix: str = "",
             copy: bool = False) -> dict[str, np.ndarray]:
    """Leaves of nested dicts / lists / tuples of tensors or arrays, keyed
    by their path joined with ``/`` (dict keys in sorted order, sequence
    indices as numbers, ``None`` leaves dropped): the keys the reference's
    ``jax.tree_util`` flattening gives the same structure.  ``copy``: each
    leaf copied (``_host``)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return {}
    else:
        return {prefix: _host(tree, copy)}
    flat = {}
    for key, value in items:
        flat.update(_flatten(value, f"{prefix}{_SEP}{key}" if prefix
                             else key, copy))
    return flat


def _unflatten(tree_like, flat: dict[str, np.ndarray], prefix: str = ""):
    """The structure of ``tree_like`` with each leaf replaced by the array
    ``flat`` holds under its key path (the keys ``_flatten`` gives);
    ``None`` leaves stay ``None``."""
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{_SEP}{k}" if prefix
                              else str(k))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten(v, flat, f"{prefix}{_SEP}{i}" if prefix else str(i))
            for i, v in enumerate(tree_like))
    if tree_like is None:
        return None
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    return flat[prefix]


def _map(fn, *trees):
    """``fn`` over the leaves of trees of the same structure (the first
    tree's; ``None`` leaves of the first stay ``None``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    return None if first is None else fn(*trees)


def _typed(x: np.ndarray, ref) -> torch.Tensor:
    """``x`` as a tensor of the template leaf ``ref``'s dtype, on its
    device (a numpy or Python template leaf: the host)."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(x).to(device=ref.device, dtype=ref.dtype)
    return torch.from_numpy(np.array(x, dtype=np.asarray(ref).dtype))


def _place(x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's part of ``x`` under ``spec``: ``None`` keeps the whole
    array (replicated); ``(mesh, dim)`` splits dimension ``dim`` into one
    equal block per rank of the mesh's ``"parts"`` dimension and keeps
    this rank's block."""
    if spec is None:
        return x
    mesh, dim = spec
    info = shard_info(mesh, x.shape[dim])
    return x.narrow(dim, _me(info) * info.part_size,
                    info.part_size).contiguous()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        # created lazily on first save: constructing a Checkpointer to
        # *read* (restore_raw / latest_step) must not touch the filesystem
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: dict[str, Any] | None = None):
        """Synchronous atomic save."""
        self._write(step, _flatten(tree), extra or {})

    def save_async(self, step: int, tree, extra: dict[str, Any] | None = None):
        """Snapshot now (host copy), write in the background."""
        self.wait()
        # the snapshot: a copy of every leaf, CPU tensors included, so
        # that the caller may update the tree in place while it is written
        flat = _flatten(tree, copy=True)
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, extra or {}), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat, extra):
        os.makedirs(self.dir, exist_ok=True)
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        fault_point("io.write")
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        fault_point("io.write")
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        fault_point("io.rename")
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_raw(self, step: int | None = None):
        """(flat {keypath: np.ndarray}, meta) without a structure template,
        for callers that rebuild typed objects from a saved manifest."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return flat, meta

    def restore(self, tree_like, step: int | None = None, shardings=None):
        """(tree, meta): the arrays of ``step`` (None = the latest) in the
        structure of ``tree_like``, each leaf a tensor of its template
        leaf's dtype (a bf16 leaf comes back from its float32 copy) on
        the template leaf's device.

        ``shardings`` (optional) is a tree of the same structure whose
        entries say what this rank keeps of each leaf: ``None`` the whole
        array (replicated); ``(mesh, dim)`` its block of dimension ``dim``
        split evenly over the ``"parts"`` dimension of ``mesh``
        (``launch/mesh.py`` ``make_index_mesh``), the reference's
        ``NamedSharding(mesh, P("parts", None))`` for ``dim = 0``.  The
        saved arrays are unsharded, so any mesh whose size divides the
        dimension restores them (elastic re-mesh)."""
        flat, meta = self.restore_raw(step)
        tree = _map(_typed, _unflatten(tree_like, flat), tree_like)
        if shardings is not None:
            tree = _map(_place, tree, shardings)
        return tree, meta
