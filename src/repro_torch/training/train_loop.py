"""Train steps with in-place updates, optional gradient compression, and
the restartable training driver (the JAX package's
``training/train_loop.py``).

The gradient is autograd's over the param tree (``models/transformer.py``
``loss_fn``, each stacked group rematerialised by ``remat_policy``); the
step is eager PyTorch, not compiled.  Where the reference donates the
state to its jitted step, the step here updates it in place.

In a world of ranks (``sharding.world_context``, one process per rank) the
same functions train the rank's blocks, as the reference's jitted step
does on a mesh: the params are ``init_model``'s blocks (each leaf drawn
whole, then cut), the moments and error buffer blocks like them, each rank
reads the loader's global batch and keeps its rows, the gradient goes
through the collectives (``sharding.py``) and is summed over the axes each
leaf is replicated over (ZeRO-3 over ``data``, heads / mlp / experts over
``model``, the batch over ``(pod, data)``), and ``loss``, ``grad_norm``,
``lr`` and ``count`` are the same on every rank.  Checkpoints of a world
are gathered to rank 0 and written unsharded (``training/checkpoint.py``),
so a run resumes in a world of another size, or on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from ..devices import resolve_device
from ..models import transformer as tf
from ..models.common import tree_leaves, tree_map
from ..sharding import MeshContext, reduce_gradients
from . import compression
from .checkpoint import Checkpointer
from .optimizer import AdamWConfig, adamw_update, init_opt_state

# the cuBLAS workspace setting deterministic mode asks for on the card
CUBLAS_WORKSPACE = ":4096:8"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    remat_policy: str = "full"            # full | dots | none
    compress_grads: bool = False          # int8 + error feedback
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, the
    earlier setting back after it.  ``train`` runs under it, so that a
    resumed run repeats the uninterrupted one bit for bit on the card too
    (the MoE dispatch's ``index_add_`` adds in no fixed order otherwise).

    On the card the mode needs ``CUBLAS_WORKSPACE_CONFIG``, which cuBLAS
    reads once, at the process's first matmul: it is set here if unset
    while CUDA is not yet initialised; set it before any CUDA work
    otherwise (``launch/train.py`` does), or PyTorch raises at the first
    matmul."""
    if ("CUBLAS_WORKSPACE_CONFIG" not in os.environ
            and not torch.cuda.is_initialized()):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def state_shardings(cfg: ArchConfig, ctx: MeshContext,
                     tcfg: TrainConfig) -> dict:
    """The partition spec of every leaf of a train state on ``ctx``'s
    mesh: params, moments and error buffer laid out as the params
    (``transformer.model_shardings``), the step count replicated."""
    specs = tf.model_shardings(cfg, ctx)
    out = {"params": specs, "opt": {"m": specs, "v": specs, "count": ()}}
    if tcfg.compress_grads:
        out["err"] = specs
    return out


def make_train_step(cfg: ArchConfig, ctx: MeshContext, tcfg: TrainConfig):
    """Returns (state, batch) -> (state, metrics).

    state = {params, opt, err?}, updated in place and returned; batch =
    {'tokens', 'labels'} tensors on the params' device (in a world the
    global batch, on every rank).  metrics: ``loss``, ``grad_norm``
    (before clipping) and ``lr``, 0-d float32 tensors (in a world the
    same on every rank).  The step runs under the caller's
    deterministic-algorithms setting (``train`` turns it on)."""
    specs = tf.model_shardings(cfg, ctx) if ctx.world is not None else None

    def step(state, batch):
        params = state["params"]
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss = tf.loss_fn(live, batch, cfg, ctx,
                          remat_policy=tcfg.remat_policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        grads = reduce_gradients(tree_map(lambda t: by_leaf[id(t)], live),
                                 ctx, specs)
        if tcfg.compress_grads:
            grads, state["err"] = compression.compressed_grads(
                grads, state["err"], ctx, specs)
        _, _, metrics = adamw_update(grads, state["opt"], params, tcfg.opt,
                                     ctx, specs)
        return state, dict(metrics, loss=loss.detach())

    return step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     tcfg: TrainConfig, dtype=torch.float32, device=None,
                     ctx: MeshContext | None = None):
    """{params, opt, err?}: random weights from ``generator``
    (``transformer.init_model``) on ``device`` (None = the card), zero
    float32 moments and error buffer; in a world (``ctx``) this rank's
    blocks of each."""
    params = tf.init_model(cfg, generator, dtype, device, ctx)
    state = {"params": params, "opt": init_opt_state(params)}
    if tcfg.compress_grads:
        state["err"] = compression.init_error_state(params)
    return state


def train(
    cfg: ArchConfig,
    ctx: MeshContext,
    tcfg: TrainConfig,
    loader,
    num_steps: int,
    *,
    ckpt_dir: str | None = None,
    resume: bool = False,
    seed: int = 0,
    dtype=torch.float32,
    log: Callable[[str], None] = print,
    device=None,
) -> dict[str, Any]:
    """Restartable training driver on ``device`` (None = the card).

    The weights come from a generator on ``device`` seeded with ``seed``
    (the card's draws differ from the CPU's).  Checkpoints (the JAX
    package's format; the step is the loader cursor) every
    ``checkpoint_every`` steps and at the end; ``resume=True`` continues
    from the latest one, repeating the uninterrupted run's losses bit for
    bit (the run is under ``deterministic_algorithms``).  Returns
    {'state', 'losses' (this run's steps)}.

    In a world (``ctx`` of ``sharding.world_context``) every rank calls
    this with the same arguments and gets its blocks of the state and the
    global losses; checkpoints are written by rank 0 (the leaves gathered
    to it) and read by every rank (its blocks cut), whatever world or
    device wrote them; ``log`` is called on every rank."""
    device = resolve_device(device)
    with deterministic_algorithms():      # before any work on the card
        step_fn = make_train_step(cfg, ctx, tcfg)
        state = init_train_state(
            cfg, torch.Generator(device).manual_seed(seed), tcfg, dtype,
            device, ctx)
        world = ({"ctx": ctx, "shardings": state_shardings(cfg, ctx, tcfg)}
                 if ctx.world is not None else {})
        start = 0
        ckpt = (Checkpointer(ckpt_dir, keep=tcfg.keep_checkpoints)
                if ckpt_dir else None)
        if resume and ckpt and ckpt.latest_step() is not None:
            state, meta = ckpt.restore(state, **world)
            start = meta["step"]
            log(f"resumed at step {start}")

        losses = []
        t0 = time.time()
        for i in range(start, num_steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in loader.batch(i).items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if tcfg.log_every and (i + 1) % tcfg.log_every == 0:
                log(
                    f"step {i + 1}/{num_steps} loss={losses[-1]:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"({(time.time() - t0) / max(1, i + 1 - start):.2f}"
                    f"s/step)"
                )
            if (ckpt and tcfg.checkpoint_every
                    and (i + 1) % tcfg.checkpoint_every == 0):
                ckpt.save_async(i + 1, state, **world)
        if ckpt:
            ckpt.wait()
            ckpt.save(num_steps, state, **world)
    return {"state": state, "losses": losses}
