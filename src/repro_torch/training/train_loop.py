"""Train steps with in-place updates, optional gradient compression, and
the restartable training driver (the JAX package's
``training/train_loop.py``).

The gradient is autograd's over the param tree (``models/transformer.py``
``loss_fn``, each stacked group rematerialised by ``remat_policy``); the
step is eager PyTorch, not compiled.  Where the reference donates the
state to its jitted step, the step here updates it in place.
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
from ..sharding import MeshContext
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


def one_device_training(ctx: MeshContext) -> None:
    """Raise for a context of a world of ranks: training there is not
    ported."""
    if ctx.world is not None:
        raise NotImplementedError(
            "training in a world of ranks (gradients through the "
            "collectives, data / FSDP / expert-parallel updates) is ROADMAP "
            "A16b and not ported; train on one device "
            "(single_device_context())")


def make_train_step(cfg: ArchConfig, ctx: MeshContext, tcfg: TrainConfig):
    """Returns (state, batch) -> (state, metrics).

    state = {params, opt, err?}, updated in place and returned; batch =
    {'tokens', 'labels'} tensors on the params' device.  metrics: ``loss``,
    ``grad_norm`` (before clipping) and ``lr``, 0-d float32 tensors.  The
    step runs under the caller's deterministic-algorithms setting
    (``train`` turns it on).  One device only: a world's context raises."""
    one_device_training(ctx)

    def step(state, batch):
        params = state["params"]
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss = tf.loss_fn(live, batch, cfg, ctx,
                          remat_policy=tcfg.remat_policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        grads = tree_map(lambda t: by_leaf[id(t)], live)
        if tcfg.compress_grads:
            grads, state["err"] = compression.compressed_grads(
                grads, state["err"])
        _, _, metrics = adamw_update(grads, state["opt"], params, tcfg.opt)
        return state, dict(metrics, loss=loss.detach())

    return step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     tcfg: TrainConfig, dtype=torch.float32, device=None):
    """{params, opt, err?}: random weights from ``generator``
    (``transformer.init_model``) on ``device`` (None = the card), zero
    float32 moments and error buffer."""
    params = tf.init_model(cfg, generator, dtype, device)
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
    {'state', 'losses' (this run's steps)}."""
    one_device_training(ctx)
    device = resolve_device(device)
    with deterministic_algorithms():      # before any work on the card
        step_fn = make_train_step(cfg, ctx, tcfg)
        state = init_train_state(
            cfg, torch.Generator(device).manual_seed(seed), tcfg, dtype,
            device)
        start = 0
        ckpt = (Checkpointer(ckpt_dir, keep=tcfg.keep_checkpoints)
                if ckpt_dir else None)
        if resume and ckpt and ckpt.latest_step() is not None:
            state, meta = ckpt.restore(state)
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
                ckpt.save_async(i + 1, state)
        if ckpt:
            ckpt.wait()
            ckpt.save(num_steps, state)
    return {"state": state, "losses": losses}
