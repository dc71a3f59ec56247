"""Carry a built index across packages as plain numpy arrays.

``fm_index_from_arrays`` / ``sequence_index_from_arrays`` take an index
given as numpy arrays under the field names of ``FM_ARRAY_FIELDS`` plus the
static ``FM_AUX_FIELDS`` (the layout both packages share, so an index built
by the JAX package is queried here unchanged); ``to_numpy`` goes the other
way.
"""

from __future__ import annotations

import numpy as np
import torch

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


def to_numpy(fm: FMIndex) -> tuple[dict, dict]:
    """(arrays, aux) of an ``FMIndex``: numpy copies on the host."""
    arrays = {name: (None if getattr(fm, name) is None
                     else getattr(fm, name).cpu().numpy())
              for name in FM_ARRAY_FIELDS}
    aux = {name: getattr(fm, name) for name in FM_AUX_FIELDS}
    return arrays, aux
