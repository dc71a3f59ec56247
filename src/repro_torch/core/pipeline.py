"""End-to-end indexing pipeline: tokens -> (SA, BWT, FM-index), on one
device.

Padding note: the text gets the unique smallest sentinel first (required
by the BWT), then pad tokens HIGHER than every real token up to a multiple
of the sample rate.  Pad suffixes consist only of pad tokens, so they can
never match a query over the real alphabet, and real char ranks are
unaffected: counting semantics are exact.

Only the single-device branch of the JAX package's pipeline lives here; a
``mesh`` argument raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import alphabet as al
from ..devices import resolve_device
from .bwt import bwt_from_sa
from .fm_index import (
    FMIndex,
    build_fm_index,
    count as fm_count,
    locate as fm_locate,
)
from .suffix_array import BuildStats, suffix_array, suffix_array_fast


class SAConfig(NamedTuple):
    """Build-engine knobs of the single-device suffix-array builder (the
    defaults of the JAX package's ``DistSAConfig``)."""

    local_sort: str = "auto"       # "compare" | "radix" | "auto"
    qgram: bool = True             # packed q-gram init (False: seed Occ init)
    qgram_words: int = 2           # 32-bit words per init key
    discard: bool = True           # drop unique-rank suffixes from the loop


@dataclasses.dataclass
class SequenceIndex:
    """A built full-text index plus query methods."""

    fm: FMIndex
    sa: torch.Tensor | None
    bwt: torch.Tensor
    row: torch.Tensor
    sigma: int
    length: int          # padded length
    text_length: int     # true length incl. sentinel
    build_stats: BuildStats | None = None

    @property
    def device(self) -> torch.device:
        return self.fm.device

    def _patterns(self, patterns) -> torch.Tensor:
        return torch.as_tensor(patterns, dtype=torch.int32,
                               device=self.device)

    def count(self, patterns) -> torch.Tensor:
        """Exact-match counts for int32[B, L] PAD-padded patterns."""
        return fm_count(self.fm, self._patterns(patterns))

    def locate(self, patterns, k: int):
        """First-k occurrence positions per pattern via the SA sample:
        (positions int32[B, k] sorted, filled with the padded length for
        unused slots; counts int32[B] clipped to k)."""
        return fm_locate(self.fm, self._patterns(patterns), k)


def prepare_tokens(
    tokens: np.ndarray, multiple: int, sigma: int | None = None,
    reserve_pad: bool | None = None,
) -> tuple[np.ndarray, int]:
    """Sentinel-terminate and pad to a multiple; returns (padded, sigma).

    ``sigma`` forces a minimum alphabet size (tokens in [1, sigma)).
    ``reserve_pad`` keeps the pad slot in the alphabet even when no padding
    tokens are appended; default (None) reserves it exactly for
    declared-``sigma`` builds.
    """
    s = al.append_sentinel(np.asarray(tokens, dtype=np.int32))
    data_sigma = al.sigma_of(s)
    declared = sigma is not None
    if declared and sigma < data_sigma:
        raise ValueError(f"tokens exceed declared alphabet {sigma}")
    if reserve_pad is None:
        reserve_pad = declared
    sigma = max(data_sigma, sigma or 0)
    pad = (-len(s)) % multiple
    if pad:
        s = np.concatenate([s, np.full(pad, sigma, np.int32)])
    if pad or reserve_pad:
        sigma += 1
    return s, sigma


def build_index_prepared(
    s, sigma: int, *, sample_rate: int = 64, sa_config: SAConfig = SAConfig(),
    sa_sample_rate: int = 32, pack: bool | None = None, fast: bool = True,
    compress_sa: bool | None = None, text_length: int | None = None,
    device=None,
) -> SequenceIndex:
    """Single-device build over an already-prepared text (a
    ``prepare_tokens``-style token array) on ``device`` (None = the GPU)."""
    dev = resolve_device(device)
    s_dev = torch.as_tensor(np.asarray(s, np.int32), device=dev)
    if fast:
        sa, stats = suffix_array_fast(
            s_dev, sigma, local_sort=sa_config.local_sort,
            qgram=sa_config.qgram, qgram_words=sa_config.qgram_words,
            discard=sa_config.discard,
        )
    else:
        sa, stats = suffix_array(s_dev, sigma), None
    bwt_arr, row = bwt_from_sa(s_dev, sa)
    sa_kw = dict(sa_sample_rate=sa_sample_rate) if sa_sample_rate else {}
    fm = build_fm_index(bwt_arr, row, sigma, sample_rate, pack=pack,
                        compress_sa=compress_sa,
                        sa=sa if sa_sample_rate else None, **sa_kw)
    n = int(s_dev.shape[0])
    return SequenceIndex(fm, sa, bwt_arr, row, sigma, n,
                         n if text_length is None else text_length,
                         build_stats=stats)


def build_index(
    tokens: np.ndarray,
    mesh=None,
    *,
    sample_rate: int = 64,
    sa_config: SAConfig = SAConfig(),
    sa_sample_rate: int = 32,
    pack: bool | None = None,
    fast: bool = True,
    sigma: int | None = None,
    compress_sa: bool | None = None,
    reserve_pad: bool | None = None,
    device=None,
) -> SequenceIndex:
    """Build a BWT/FM index over raw tokens (no sentinel) on one device.

    ``device`` None means the GPU (raises when there is none; pass
    ``device="cpu"`` for the plain path).  The suffix array is sampled every
    ``sa_sample_rate``-th text position into the index for
    ``SequenceIndex.locate`` (0 skips it).  ``pack`` / ``compress_sa`` as in
    ``build_fm_index``; ``sigma`` / ``reserve_pad`` as in
    ``prepare_tokens``; ``fast=False`` runs the seed builder.
    """
    if mesh is not None:
        raise NotImplementedError("the mesh (multi-device) build is not "
                                  "ported yet; pass mesh=None")
    dev = resolve_device(device)
    tokens = np.asarray(tokens, dtype=np.int32)
    s, sigma = prepare_tokens(tokens, sample_rate, sigma, reserve_pad)
    return build_index_prepared(
        s, sigma, sample_rate=sample_rate, sa_config=sa_config,
        sa_sample_rate=sa_sample_rate, pack=pack, fast=fast,
        compress_sa=compress_sa, text_length=len(tokens) + 1, device=dev,
    )
