"""End-to-end indexing pipeline: tokens -> (SA, BWT, FM-index), on one
device.

Padding note: the text gets the unique smallest sentinel first (required
by the BWT), then pad tokens HIGHER than every real token up to a multiple
of the sample rate.  Pad suffixes consist only of pad tokens, so they can
never match a query over the real alphabet, and real char ranks are
unaffected: counting semantics are exact.

With a ``mesh`` (``launch/mesh.py`` ``make_index_mesh``, a
``torch.distributed`` ``DeviceMesh`` with a ``"parts"`` dimension) every
rank calls ``build_index`` with the same tokens and gets its part of a
distributed index (``core/dist_fm.py``): SPMD needs n divisible by
parts * sample_rate, and the same pad tokens make it so.  Every rank then
issues the same query batches.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import alphabet as al
from ..devices import resolve_device
from .bwt import bwt_from_sa
from .dist_fm import DistFMIndex, build_dist_fm_index, dist_count, dist_locate
from .dist_sort import mesh_parts
from .dist_suffix_array import (
    DistSAConfig,
    dist_bwt_local,
    dist_isa_local,
    isa_overflowed,
    local_text,
)
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


def build_sa_config(cfg) -> SAConfig:
    """The single-device builder's knobs of an ``SAConfig`` or a
    ``DistSAConfig``."""
    if isinstance(cfg, SAConfig):
        return cfg
    return SAConfig(local_sort=cfg.local_sort, qgram=cfg.qgram,
                    qgram_words=cfg.qgram_words, discard=cfg.discard)


def dist_sa_config(cfg) -> DistSAConfig:
    """A ``DistSAConfig`` of a ``DistSAConfig`` or an ``SAConfig`` (the
    mesh knobs at their defaults)."""
    if isinstance(cfg, DistSAConfig):
        return cfg
    return DistSAConfig(local_sort=cfg.local_sort, qgram=cfg.qgram,
                        qgram_words=cfg.qgram_words, discard=cfg.discard)


def mesh_sa_config(cfg) -> DistSAConfig:
    """The mesh build's ``DistSAConfig`` of a ``BWTIndexConfig``: its
    engine, capacity factor and doubling rounds, and its build-engine
    knobs (the reference's dry run builds the same one)."""
    return DistSAConfig(engine=cfg.engine,
                        capacity_factor=cfg.capacity_factor,
                        rounds=cfg.rounds, qgram=cfg.qgram,
                        qgram_words=cfg.qgram_words, discard=cfg.discard,
                        local_sort=cfg.local_sort)


@dataclasses.dataclass
class SequenceIndex:
    """A built full-text index plus query methods.  On a mesh, ``fm``,
    ``sa`` and ``bwt`` are this rank's parts (``length`` stays global)."""

    fm: FMIndex | DistFMIndex
    sa: torch.Tensor | None
    bwt: torch.Tensor
    row: torch.Tensor
    sigma: int
    length: int          # padded length
    text_length: int     # true length incl. sentinel
    build_stats: BuildStats | None = None
    mesh: object = None  # the DeviceMesh of a distributed index
    # the DistSAConfig a mesh build finished with: its capacity factor is
    # the requested one doubled once per samplesort overflow retry
    mesh_config: DistSAConfig | None = None

    @property
    def device(self) -> torch.device:
        return self.fm.device

    def _patterns(self, patterns) -> torch.Tensor:
        return torch.as_tensor(patterns, dtype=torch.int32,
                               device=self.device)

    def count(self, patterns) -> torch.Tensor:
        """Exact-match counts for int32[B, L] PAD-padded patterns."""
        if self.mesh is None:
            return fm_count(self.fm, self._patterns(patterns))
        return dist_count(self.fm, self._patterns(patterns), self.mesh)

    def locate(self, patterns, k: int):
        """First-k occurrence positions per pattern via the SA sample:
        (positions int32[B, k] sorted, filled with the padded length for
        unused slots; counts int32[B] clipped to k)."""
        if self.mesh is None:
            return fm_locate(self.fm, self._patterns(patterns), k)
        return dist_locate(self.fm, self._patterns(patterns), k, self.mesh)


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
    s, sigma: int, *, sample_rate: int = 64, sa_config=SAConfig(),
    sa_sample_rate: int = 32, pack: bool | None = None, fast: bool = True,
    compress_sa: bool | None = None, text_length: int | None = None,
    device=None,
) -> SequenceIndex:
    """Single-device build over an already-prepared text (a
    ``prepare_tokens``-style token array) on ``device`` (None = the GPU);
    ``sa_config`` an ``SAConfig`` or a ``DistSAConfig``."""
    dev = resolve_device(device)
    sa_config = build_sa_config(sa_config)
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
    sa_config=SAConfig(),
    max_retries: int = 3,
    sa_sample_rate: int = 32,
    pack: bool | None = None,
    fast: bool = True,
    sigma: int | None = None,
    compress_sa: bool | None = None,
    reserve_pad: bool | None = None,
    device=None,
) -> SequenceIndex:
    """Build a BWT/FM index over raw tokens (no sentinel): on one device,
    or distributed over ``mesh``.

    ``device`` None means the GPU (raises when there is none; pass
    ``device="cpu"`` for the plain path).  The suffix array is sampled every
    ``sa_sample_rate``-th text position into the index for
    ``SequenceIndex.locate`` (0 skips it).  ``pack`` / ``compress_sa`` as in
    ``build_fm_index``; ``sigma`` / ``reserve_pad`` as in
    ``prepare_tokens``; ``fast=False`` runs the seed builder (one device).
    ``sa_config`` is an ``SAConfig`` or a ``DistSAConfig`` (the mesh
    build's engine and capacity knobs; an ``SAConfig`` takes their
    defaults).

    With a mesh, every rank passes the same tokens; a samplesort capacity
    overflow is retried with a doubled ``capacity_factor``, up to
    ``max_retries`` builds.
    """
    dev = resolve_device(device)
    tokens = np.asarray(tokens, dtype=np.int32)
    text_length = len(tokens) + 1
    if mesh is None:
        s, sigma = prepare_tokens(tokens, sample_rate, sigma, reserve_pad)
        return build_index_prepared(
            s, sigma, sample_rate=sample_rate, sa_config=sa_config,
            sa_sample_rate=sa_sample_rate, pack=pack, fast=fast,
            compress_sa=compress_sa, text_length=text_length, device=dev,
        )

    cfg = dist_sa_config(sa_config)
    parts = mesh_parts(mesh, cfg.axis)
    s, sigma = prepare_tokens(tokens, parts * sample_rate, sigma, reserve_pad)
    info, s_local = local_text(s, mesh, cfg.axis, dev)
    for _ in range(max_retries):
        isa = dist_isa_local(info, cfg, s_local, sigma)
        if not isa_overflowed(isa):
            break
        cfg = cfg._replace(capacity_factor=cfg.capacity_factor * 2)
    else:
        raise RuntimeError(
            f"samplesort capacity overflow after {max_retries} retries "
            f"(factor {cfg.capacity_factor})")
    sa, bwt_arr, row = dist_bwt_local(info, cfg, s_local, isa)
    del isa, s_local
    sa_kw = dict(sa_sample_rate=sa_sample_rate) if sa_sample_rate else {}
    fm = build_dist_fm_index(bwt_arr, row, mesh, sigma=sigma,
                             sample_rate=sample_rate, pack=pack,
                             compress_sa=compress_sa,
                             sa=sa if sa_sample_rate else None, **sa_kw)
    return SequenceIndex(fm, sa, bwt_arr, fm.row, sigma, len(s), text_length,
                         mesh=mesh, mesh_config=cfg)
