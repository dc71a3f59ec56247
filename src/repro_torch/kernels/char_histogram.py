"""Token histogram (the paper's Init map/reduce): int32 tokens -> int32
counts per symbol in [0, sigma); values outside that range count nowhere.
Plain PyTorch version + CUDA kernel (``csrc/char_histogram.cu``).
"""

from __future__ import annotations

import torch

from . import _build, traffic

MAX_SIGMA = 12288   # sigma int32 bins in 48 KiB of shared memory per block


def char_histogram_plain(tokens: torch.Tensor, sigma: int) -> torch.Tensor:
    """int32[sigma] counts.  Out-of-range values go to one extra bin that
    is dropped: ``bincount`` raises on negatives and would grow past
    ``sigma``."""
    flat = tokens.reshape(-1)
    keep = torch.where((flat >= 0) & (flat < sigma), flat, sigma)
    return torch.bincount(keep, minlength=sigma + 1)[:sigma].to(torch.int32)


@traffic.reports("char_histogram", lambda tokens, sigma:
                 traffic.char_histogram_bytes(tokens.numel(), sigma))
def char_histogram(tokens: torch.Tensor, sigma: int) -> torch.Tensor:
    """Token histogram; the plain version for CPU tensors, the CUDA kernel
    otherwise."""
    if _build.on_cpu(tokens):
        return char_histogram_plain(tokens, sigma)
    _build.check_cuda("char_histogram", tokens)
    if not 0 < sigma <= MAX_SIGMA:
        raise ValueError(f"char_histogram: sigma={sigma} outside "
                         f"(0, {MAX_SIGMA}]")
    n = tokens.numel()
    if n >= 1 << 31:
        raise ValueError(f"char_histogram: {n} tokens exceed int32 indexing")
    counts = torch.zeros(sigma, dtype=torch.int32, device=tokens.device)
    if n:
        _build.launch("char_histogram", tokens.data_ptr(), n, sigma,
                      counts.data_ptr())
    return counts
