"""Carry a built index across packages as plain numpy arrays.

``fm_index_from_arrays`` / ``sequence_index_from_arrays`` take an index
given as numpy arrays under the field names of ``FM_ARRAY_FIELDS`` plus the
static ``FM_AUX_FIELDS`` (the layout both packages share, so an index built
by the JAX package is queried here unchanged); ``to_numpy`` goes the other
way.

A distributed index crosses the same way: ``dist_fm_index_from_arrays``
takes the global arrays of a ``DistFMIndex`` (the JAX package's, under
``dist_fm.DIST_ARRAY_FIELDS`` / ``DIST_AUX_FIELDS``) on every rank, and
each rank keeps its shard of the sharded fields; ``to_numpy`` with the
mesh gathers a rank's index back into the global arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .dist_fm import (
    DIST_ARRAY_FIELDS,
    DIST_AUX_FIELDS,
    SHARDED_FIELDS,
    DistFMIndex,
)
from .dist_sort import _me, mesh_parts, shard_info
from .dist_suffix_array import gather_shards
from .fm_index import FM_ARRAY_FIELDS, FM_AUX_FIELDS, FMIndex
from .pipeline import SequenceIndex


def fm_index_from_arrays(arrays: dict, aux: dict, device) -> FMIndex:
    """``arrays``: field name -> numpy array (a missing or None field stays
    None); ``aux``: the static fields.  Arrays land as int32 tensors on
    ``device``."""
    kw = {}
    for name in FM_ARRAY_FIELDS:
        a = arrays.get(name)
        kw[name] = None if a is None else torch.as_tensor(
            np.array(a, np.int32), device=device)
    kw.update({name: int(aux[name]) for name in FM_AUX_FIELDS})
    return FMIndex(**kw)


def sequence_index_from_arrays(arrays: dict, aux: dict, device, *,
                               sa=None, text_length: int | None = None
                               ) -> SequenceIndex:
    """A queryable ``SequenceIndex`` around ``fm_index_from_arrays``: the
    unpadded BWT, row, sigma and length come from the FM fields; ``sa`` is
    optional (the SA sample inside the FM fields is what locate reads)."""
    fm = fm_index_from_arrays(arrays, aux, device)
    n = fm.length
    sa_t = None if sa is None else torch.as_tensor(
        np.array(sa, np.int32), device=device)
    return SequenceIndex(fm, sa_t, fm.bwt[:n], fm.row, fm.sigma, n,
                         n if text_length is None else text_length)


def dist_fm_index_from_arrays(arrays: dict, aux: dict, mesh,
                              device) -> DistFMIndex:
    """This rank's part of a distributed index given by its global
    arrays (field name -> numpy, a missing or None field stays None) and
    static fields: the rank slices its shard of ``SHARDED_FIELDS`` and
    keeps the rest whole, as int32 tensors on ``device``."""
    parts = int(aux["parts"])
    if mesh_parts(mesh) != parts:
        raise ValueError(f"index of {parts} parts on a mesh of "
                         f"{mesh_parts(mesh)}")
    me = _me(shard_info(mesh, int(aux["length"])))
    kw = {}
    for name in DIST_ARRAY_FIELDS:
        a = arrays.get(name)
        if a is not None and name in SHARDED_FIELDS:
            rows = a.shape[0] // parts
            a = a[me * rows: (me + 1) * rows]
        kw[name] = None if a is None else torch.as_tensor(
            np.array(a, np.int32), device=device)
    kw.update({name: int(aux[name]) for name in DIST_AUX_FIELDS})
    return DistFMIndex(**kw)


def to_numpy(fm, mesh=None) -> tuple[dict, dict]:
    """(arrays, aux) of an ``FMIndex``, or of a rank's ``DistFMIndex``
    with its ``mesh`` (the shards gathered into the global arrays, on
    every rank): numpy copies on the host."""
    if isinstance(fm, DistFMIndex):
        info = shard_info(mesh, fm.length)
        arrays = {}
        for name in DIST_ARRAY_FIELDS:
            a = getattr(fm, name)
            if a is not None and name in SHARDED_FIELDS:
                a = gather_shards(info, a)
            arrays[name] = None if a is None else a.cpu().numpy()
        return arrays, {name: getattr(fm, name) for name in DIST_AUX_FIELDS}
    arrays = {name: (None if getattr(fm, name) is None
                     else getattr(fm, name).cpu().numpy())
              for name in FM_ARRAY_FIELDS}
    aux = {name: getattr(fm, name) for name in FM_AUX_FIELDS}
    return arrays, aux
