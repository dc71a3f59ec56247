"""Device policy shared by the entry points (``pipeline.build_index``,
``serving.engine.FMQueryServer``, ``launch.serve``)."""

from __future__ import annotations

import torch


def resolve_device(device=None, *, allow_meta: bool = False) -> torch.device:
    """``None`` means the GPU.  Raises when the GPU is asked for (or
    implied) and none is present: the CPU is only ever an explicit choice
    (``device="cpu"``), never a silent fallback.  ``meta`` (shapes and
    dtypes, no storage) is an explicit choice too, and only where the
    caller allows it: the LM's ``transformer.init_cache`` for
    ``launch/dryrun.py``'s traces (``abstract_model`` gives the params);
    the index entry points refuse it."""
    dev = torch.device("cuda" if device is None else device)
    if allow_meta and dev.type == "meta":
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
