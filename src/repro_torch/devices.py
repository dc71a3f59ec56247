"""Device policy shared by the entry points (``pipeline.build_index``,
``serving.engine.FMQueryServer``, ``launch.serve``)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  Raises when the GPU is asked for (or
    implied) and none is present: the CPU is only ever an explicit choice
    (``device="cpu"``), never a silent fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
