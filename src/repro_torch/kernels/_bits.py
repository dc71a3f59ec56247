"""Unsigned 32-bit word math on int32 storage.

PyTorch on the CPU refuses ``>>``/``<<`` on ``uint32`` and has no
popcount, so the plain versions keep int32 storage and do bit math in
int64 masked to 32 bits; the CUDA kernels read the same storage as
``uint32`` and use ``__popc``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) words -> int64 holding their unsigned value."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32) -> int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24
