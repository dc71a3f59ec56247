"""BWT/FM-index powered data hygiene for LM training (the JAX package's
``data/dedup.py``): the index built by ``core.pipeline`` answers
exact-substring queries over the whole corpus, so the data pipeline can

  * drop exact duplicate windows (train-time dedup), and
  * screen held-out/eval sequences that leak into the corpus
    (contamination).

Each ``index.count`` call is one fused query launch on the card; a
symbol outside the index alphabet matches nothing.
"""

from __future__ import annotations

import numpy as np

from ..core.fm_index import PAD
from ..core.pipeline import SequenceIndex, build_index


def build_corpus_index(tokens: np.ndarray, mesh=None, *, device=None,
                       **kw) -> SequenceIndex:
    """``build_index`` over the corpus on ``device`` (None = the GPU)."""
    return build_index(tokens, mesh, device=device, **kw)


def duplicate_window_mask(
    index: SequenceIndex, tokens: np.ndarray, window: int,
    stride: int | None = None, threshold: int = 2, batch: int = 256,
) -> np.ndarray:
    """mask[i] = True when the window starting at i occurs >= ``threshold``
    times in the indexed corpus (an exact duplicate somewhere else).

    Windows start every ``stride`` tokens (default ``window``), ``batch``
    of them per ``index.count`` call; a flagged window marks its
    ``stride`` tokens."""
    stride = stride or window
    tokens = np.asarray(tokens)
    n = len(tokens)
    starts = np.arange(0, n - window, stride)
    hit = np.zeros(len(starts), dtype=bool)
    offs = np.arange(window)
    for lo in range(0, len(starts), batch):
        chunk = starts[lo: lo + batch]
        pats = tokens[chunk[:, None] + offs[None, :]].astype(np.int32)
        hit[lo: lo + len(chunk)] = index.count(pats).cpu().numpy() \
            >= threshold
    # window j marks [j*stride, (j+1)*stride): the runs tile the front of
    # the mask without overlap, so one repeat sets them all
    mask = np.zeros(n, dtype=bool)
    marks = np.repeat(hit, stride)[:n]
    mask[: len(marks)] = marks
    return mask


def contamination_report(
    index: SequenceIndex, eval_sequences: list[np.ndarray],
    probe_len: int = 32,
) -> dict:
    """For each eval sequence, count corpus hits of its probes (every
    ``probe_len`` tokens; a shorter sequence is one probe), all in one
    ``index.count`` call."""
    probes = []
    owners = []
    for i, seq in enumerate(eval_sequences):
        for s in range(0, max(1, len(seq) - probe_len + 1), probe_len):
            probes.append(seq[s: s + probe_len])
            owners.append(i)
    L = max(len(p) for p in probes)
    pats = np.full((len(probes), L), PAD, np.int32)
    for j, p in enumerate(probes):
        pats[j, : len(p)] = p
    counts = index.count(pats).cpu().numpy()
    hits = {}
    for i, c in zip(owners, counts):
        hits[i] = hits.get(i, 0) + int(c > 0)
    return {
        "contaminated": sorted(k for k, v in hits.items() if v > 0),
        "probe_hits": hits,
    }
