"""The index mesh, a world of local ranks to run it in, and the LM
harness's mesh shapes.

``make_production_mesh`` / ``make_debug_mesh`` give the axis sizes of the
JAX package's LM meshes by the same arithmetic (a dict of axis name ->
size, what ``sharding.MeshContext`` takes).  ``make_lm_mesh`` turns such
sizes into the LM's world: a ``DeviceMesh`` with those dims (``("pod",
"data", "model")``), rank r at the row-major coordinate r, the argument of
``sharding.world_context``.  ``run_world`` and ``launched_world`` hand a
rank that mesh when given ``mesh_shape``:

    run_world(4, fn, prompts, mesh_shape=make_debug_mesh(4))
    # fn(mesh, prompts) in ranks 0..3, mesh over (pod 1, data 2, model 2)

``make_index_mesh`` is the counterpart of the JAX package's
``launch/mesh.py`` ``make_index_mesh``: a one-dimensional
``torch.distributed`` ``DeviceMesh`` whose dimension is named ``"parts"``,
the mesh argument of ``pipeline.build_index`` and of the ``dist_*``
modules.  It is made inside an initialised process group, one process per
rank.  Its device type names the transport: ``"cuda"`` is NCCL, one rank
per card; ``"cpu"`` is gloo, which also serves ranks that share one card
(their CUDA tensors are staged through host memory by
``core.dist_sort``'s collectives).

``launched_world`` joins the world an external launcher started this
process in (``python -m torch.distributed.run``, which ships with torch,
sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the store's address in
each rank's environment); the serving launcher runs in it.

``meta_world`` makes this process one rank of a world of any size in
which no data moves (torch's fake process group): a full-size step of
the 256- or 512-rank production mesh is traced there on ``meta`` for one
rank (``launch/dryrun.py``).

``run_world`` runs a function in each rank of a world of ``parts`` local
processes and returns each rank's result as numpy (``single_rank_world``
makes the calling process a world of one):

    results = run_world(4, fn, tokens)   # fn(mesh, tokens) in ranks 0..3

The ranks rendezvous through a ``file://`` store in a temporary directory
(no port, so concurrent worlds never collide).  The process group and the
wait for the ranks share one timeout; a rank that raises, dies or
outlives it fails the whole world (the other ranks are killed) with the
rank's traceback.  ``fn`` must be importable by name (a module-level
function): the ranks are spawned, not forked.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback

AXIS = "parts"
TRANSPORTS = {"cpu": "gloo", "cuda": "nccl"}   # mesh device type -> backend


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """Axis sizes of the production LM mesh: 16 x 16 per pod, 2 pods for
    multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_debug_mesh(devices: int | None = None) -> dict:
    """Small (pod, data, model) axis sizes over ``devices`` devices (by
    default the CUDA devices present, at least one)."""
    import torch

    n = devices or max(1, torch.cuda.device_count())
    if n == 1:
        return {"pod": 1, "data": 1, "model": 1}
    if n % 2:
        raise ValueError(f"need an even device count, got {n}")
    model = 2
    pod, data = 1, n // 2
    if n >= 8:
        pod, data = 2, n // (2 * model)
    return {"pod": pod, "data": data, "model": model}


def make_index_mesh(device_type: str, *, parts: int | None = None):
    """Flat ``(parts,)`` mesh named ``"parts"`` over the initialised world
    (``parts`` defaults to the world size)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in TRANSPORTS:
        raise ValueError(f"mesh device type {device_type!r} is not one of "
                         f"{sorted(TRANSPORTS)}")
    if parts is None:
        parts = dist.get_world_size()
    return init_device_mesh(device_type, (parts,), mesh_dim_names=(AXIS,))


def make_lm_mesh(device_type: str, axes: dict):
    """The LM's ``DeviceMesh`` over the initialised world: dims named and
    sized as ``axes`` (axis name -> size, their product the world size),
    row-major.  ``device_type`` names the transport as for
    ``make_index_mesh``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in TRANSPORTS:
        raise ValueError(f"mesh device type {device_type!r} is not one of "
                         f"{sorted(TRANSPORTS)}")
    shape = tuple(axes.values())
    size = 1
    for n in shape:
        size *= n
    if size != dist.get_world_size():
        raise ValueError(f"mesh {axes} needs {size} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axes))


def _mesh(device_type: str, parts: int, mesh_shape):
    if mesh_shape is None:
        return make_index_mesh(device_type, parts=parts)
    return make_lm_mesh(device_type, mesh_shape)


def _to_numpy(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _join(workdir: str, rank: int, parts: int, device_type: str,
          timeout_s: float) -> None:
    """Join the world of ``parts`` ranks that rendezvous under
    ``workdir``, with ``timeout_s`` on every collective."""
    import torch
    import torch.distributed as dist

    _refuse_nesting("a world of ranks")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        TRANSPORTS[device_type], init_method=f"file://{workdir}/store",
        rank=rank, world_size=parts,
        timeout=datetime.timedelta(seconds=timeout_s))


@contextlib.contextmanager
def single_rank_world(device_type: str, timeout_s: float = 300.0):
    """This process as the one rank of a world; yields its index mesh (of
    one part) and leaves the world on exit."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="repro_world_") as workdir:
        _join(workdir, 0, 1, device_type, timeout_s)
        try:
            yield make_index_mesh(device_type, parts=1)
        finally:
            dist.destroy_process_group()


def _refuse_nesting(what: str) -> None:
    """Raise when this process already belongs to a process group: a real
    world and a meta world never share a process."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError(
            f"{what} cannot open inside the process group this process "
            f"already belongs to (backend "
            f"{dist.get_backend()!r}, {dist.get_world_size()} ranks); "
            f"leave that world first")


@contextlib.contextmanager
def meta_world(axes: dict, rank: int = 0):
    """This process as rank ``rank`` of a world of ``prod(axes)`` ranks in
    which no data moves; yields its LM mesh (``make_lm_mesh("cpu",
    axes)``) and leaves the world on exit.

    The world's process group is torch's fake backend: every rank of the
    mesh has its coordinates and its groups, and a collective returns at
    once.  ``core/dist_sort.py`` takes ``meta`` tensors only on such a
    group (any other raises) and gives each collective's result the shape
    and dtype the real call gives, so a step traced here on ``meta``
    (``roofline.count``) is one rank's step of the full mesh, its
    collectives counted as in a real world, without the other ranks.
    Refuses to open inside another world, as a real world refuses to open
    inside this one."""
    import torch.distributed as dist

    from ..core.dist_sort import META_BACKEND

    _refuse_nesting("a meta world")
    size = 1
    for n in axes.values():
        size *= n
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not one of the {size} ranks of "
                         f"mesh {axes}")
    # registers the fake backend's process group with torch.distributed
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group(META_BACKEND, store=dist.HashStore(), rank=rank,
                            world_size=size)
    try:
        yield make_lm_mesh("cpu", axes)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def launched_world(device, timeout_s: float = 300.0, mesh_shape=None):
    """Join the world ``torch.distributed.run`` started this process in
    and yield its index mesh, or its LM mesh of ``mesh_shape``
    (``make_lm_mesh``) when given (None, joining nothing, when the
    environment names no world of more than one rank); leave the world on
    exit.

    Ranks on the GPU (``device`` of type cuda) take one card each over
    NCCL when the host has a card for every local rank; ranks that share
    a card run gloo (``core.dist_sort`` stages their CUDA tensors through
    the host), as do ranks on the CPU."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        yield None
        return
    device_type = "cpu"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % cards)
        if int(os.environ.get("LOCAL_WORLD_SIZE", str(world))) <= cards:
            device_type = "cuda"
    dist.init_process_group(TRANSPORTS[device_type], init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield _mesh(device_type, world, mesh_shape)
    finally:
        dist.destroy_process_group()


def _rank_main(workdir: str, rank: int, parts: int, device_type: str,
               timeout_s: float, fn, args, mesh_shape=None) -> None:
    """One rank: join the world, build the mesh, run ``fn``, write its
    result (or the traceback) under ``workdir``, then leave at once.

    The rank skips the interpreter's teardown (``os._exit``, as a forked
    child leaves): once the outcome is on disk there is nothing left to
    do, and the teardown of the process group's native state could abort
    the process ("terminate called without an active exception", exit
    -6) after a good result, failing the world."""
    import torch
    import torch.distributed as dist

    code = 0
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // parts))
        _join(workdir, rank, parts, device_type, timeout_s)
        try:
            out = _to_numpy(fn(_mesh(device_type, parts, mesh_shape),
                               *args))
        finally:
            dist.destroy_process_group()
        with open(f"{workdir}/result_{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except Exception:
        # recorded for the parent, which raises it with the other ranks'
        # outcomes
        with open(f"{workdir}/error_{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def run_world(parts: int, fn, *args, device_type: str = "cpu",
              timeout_s: float = 300.0, mesh_shape=None) -> list:
    """``fn(mesh, *args)`` in each rank of a spawned world of ``parts``
    processes; returns the ranks' results (tensors as numpy), rank order.
    ``mesh`` is the index mesh, or the LM mesh of ``mesh_shape`` (axis
    name -> size, ``make_lm_mesh``) when given.

    Raises ``RuntimeError`` naming the ranks that failed (with their
    tracebacks) when any rank raises or exits nonzero, or when the world
    outlives ``timeout_s``; no rank is left running either way."""
    if parts < 1:
        raise ValueError(f"a world needs at least one rank, got {parts}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_world_") as workdir:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(workdir, r, parts, device_type, timeout_s,
                                   fn, args, mesh_shape))
                 for r in range(parts)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a rank failed: give the others a moment to report
                    # their own errors, then stop them
                    grace = time.monotonic() + 2.0
                    for p in procs:
                        p.join(timeout=max(0.0, grace - time.monotonic()))
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10.0)
        failed = []
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"error_{r}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    failed.append(f"rank {r} raised:\n{f.read()}")
            elif p.exitcode != 0 and not timed_out:
                failed.append(f"rank {r} exited with code {p.exitcode}")
        if timed_out:
            failed.insert(0, f"the world of {parts} ranks did not finish "
                             f"within {timeout_s} s")
        if failed:
            raise RuntimeError("\n".join(failed))
        results = []
        for r in range(parts):
            with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
