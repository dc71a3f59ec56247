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
  * worlds   — in the LM's world of ranks (``ctx`` of
               ``sharding.world_context``, each leaf the rank's block by
               its spec in ``shardings``) ``save`` gathers each leaf whole
               to rank 0, one leaf at a time, and rank 0 alone writes the
               same unsharded files; ``restore(..., ctx=ctx)`` cuts each
               rank's block of a leaf as it is read, so a state saved by
               one world size (or one device, or the JAX package) resumes
               in any other.

``restore`` fills the structure of a template tree; ``restore_raw``
serves callers that rebuild typed objects from a manifest
(``core/index_io.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile
from typing import Any

import numpy as np
import torch

from ..core import dist_sort as ds
from ..core.dist_sort import _me, shard_info
from ..sharding import axes_of
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


def _keyed(tree, other, prefix: str = ""):
    """(key path, leaf, ``other``'s entry at the same place) of every leaf
    of ``tree`` in ``_flatten``'s order and keys; ``tree`` alone gives the
    structure (``other``'s entries may be tuples, e.g. partition specs)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed(tree[k], other[k], f"{prefix}{_SEP}{k}"
                              if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed(v, other[i], f"{prefix}{_SEP}{i}" if prefix
                              else str(i))
    elif tree is not None:
        yield prefix, tree, other


def _gathered(tree, ctx, shardings) -> dict[str, np.ndarray] | None:
    """Rank 0: every leaf of ``tree`` (this rank's blocks, laid out by
    their specs in ``shardings``) whole, as host arrays of their own;
    None on the other ranks.  One leaf at a time, each split dim gathered
    one mesh axis at a time (``dist_sort.gather`` to the axis's first
    rank, the minor axis first), only by the ranks at coordinate 0 of
    every axis the leaf is replicated over and already gathered: each
    block crosses once, its copies not at all."""
    first = ctx.coordinate(tuple(ctx.mesh)) == 0
    flat = {} if first else None
    for key, leaf, spec in _keyed(tree, shardings):
        x = None
        if not any(ctx.coordinate((a,)) for a in ctx.replicated(spec)):
            x = leaf.detach().to("cpu", copy=True)
        for dim, entry in enumerate(spec):
            for a in reversed(axes_of(entry)):
                if x is None or ctx.mesh[a] == 1:
                    continue
                blocks = ds.gather(ds.axis_info(ctx.world, a), x)
                x = None if blocks is None else torch.cat(blocks.unbind(0),
                                                          dim)
        if first:
            flat[key] = _host(x)
    return flat


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
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: dict[str, Any] | None = None,
             *, ctx=None, shardings=None):
        """Synchronous atomic save.  In a world (``ctx`` holding one, every
        rank making the same call with its blocks, laid out by their specs
        in ``shardings``) the leaves are gathered to rank 0, which writes;
        every rank then learns the write's outcome in one collective, and a
        failed write raises on every rank."""
        if ctx is None or ctx.world is None:
            self._write(step, _flatten(tree), extra or {})
            return
        flat = _gathered(tree, ctx, shardings)
        error = None
        if flat is not None:
            try:
                self._write(step, flat, extra or {})
            except Exception as e:          # raised after the collective
                error = e
        failed = ds.pmax(ds.world_info(ctx.world),
                         torch.tensor(error is not None))
        if error is not None:
            raise error
        if bool(failed):
            raise RuntimeError(f"rank 0 failed to write checkpoint step "
                               f"{step} under {self.dir!r}")

    def save_async(self, step: int, tree, extra: dict[str, Any] | None = None,
                   *, ctx=None, shardings=None):
        """Snapshot now (host copy), write in the background.  In a world
        (as ``save``) the snapshot is the gather to rank 0, made now on
        every rank; rank 0 alone writes, and its ``wait`` raises if the
        write failed."""
        self.wait()
        if ctx is None or ctx.world is None:
            # the snapshot: a copy of every leaf, CPU tensors included, so
            # that the caller may update the tree in place while it is
            # written
            flat = _flatten(tree, copy=True)
        else:
            flat = _gathered(tree, ctx, shardings)
            if flat is None:
                return
        self._error = None
        self._thread = threading.Thread(
            target=self._write_caught, args=(step, flat, extra or {}),
            daemon=True)
        self._thread.start()

    def _write_caught(self, step: int, flat, extra):
        try:
            self._write(step, flat, extra)
        except BaseException as e:          # raised again by ``wait``
            self._error = e

    def wait(self):
        """Wait for the background write; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            error, self._error = self._error, None
            if error is not None:
                raise error

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

    def restore(self, tree_like, step: int | None = None, shardings=None,
                *, ctx=None):
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
        dimension restores them (elastic re-mesh).

        With ``ctx`` (the context of the LM's world of ranks) each entry of
        ``shardings`` is the leaf's partition spec (``ctx.spec_for``) and
        this rank keeps its block, cut from each leaf as it is read."""
        if ctx is not None and ctx.world is not None:
            return self._restore_blocks(tree_like, step, shardings, ctx)
        flat, meta = self.restore_raw(step)
        tree = _map(_typed, _unflatten(tree_like, flat), tree_like)
        if shardings is not None:
            tree = _map(_place, tree, shardings)
        return tree, meta

    def _restore_blocks(self, tree_like, step, shardings, ctx):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        blocks = {}
        for key, ref, spec in _keyed(tree_like, shardings):
            whole = _npz_leaf(os.path.join(path, "arrays.npz"), key)
            blocks[key] = _typed(
                np.array(whole[ctx.block(spec, whole.shape)]), ref)
            del whole
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return _unflatten(tree_like, blocks), meta


def _npz_leaf(path: str, key: str) -> np.ndarray:
    """Leaf ``key`` of the npz at ``path``: a read-only memory map of its
    bytes where the archive stores it uncompressed (``np.savez`` does), so
    that a rank reading its block of a leaf reads that block's pages, not
    the whole leaf; otherwise the leaf read whole."""
    name = key + ".npy"
    with zipfile.ZipFile(path) as z:
        try:
            info = z.getinfo(name)
        except KeyError:
            raise KeyError(f"checkpoint missing leaf {key!r}") from None
        if info.compress_type != zipfile.ZIP_STORED:
            with z.open(name) as f:
                return np.lib.format.read_array(f)
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        n_name, n_extra = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(f)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read is not None:
            shape, fortran, dtype = read(f)
            offset = f.tell()
    if read is None or dtype.hasobject or not shape or 0 in shape:
        with np.load(path) as z:
            return z[key]
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")
