"""Deterministic, resumable batching for LM training (the JAX package's
``data/loader.py``, batch for batch the same output).

Stateless sampling: batch ``i`` is a pure function of ``(seed, i)``: any
worker can (re)compute any batch, restarts are bitwise-exact, and there is
no shuffle state to lose on preemption.  Batches are numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LABEL_PAD = -1   # label of a position the loss ignores (the reference's)


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    batch_size: int
    seq_len: int
    seed: int = 0


class TokenLoader:
    """Samples fixed-length windows from a token corpus."""

    def __init__(self, tokens: np.ndarray, cfg: LoaderConfig,
                 drop_mask: np.ndarray | None = None):
        self.tokens = np.asarray(tokens, dtype=np.int32)
        self.cfg = cfg
        self.n = len(self.tokens)
        # windows flagged by dedup (duplicate_window_mask) are never sampled
        self.drop_mask = drop_mask

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step])
        )
        max_start = self.n - cfg.seq_len - 1
        starts = rng.integers(0, max_start, cfg.batch_size)
        if self.drop_mask is not None:
            for _ in range(8):  # resample dropped windows
                bad = self.drop_mask[starts]
                if not bad.any():
                    break
                starts[bad] = rng.integers(0, max_start, int(bad.sum()))
        idx = starts[:, None] + np.arange(cfg.seq_len + 1)[None, :]
        window = self.tokens[idx]
        return {
            "tokens": window[:, :-1].copy(),
            "labels": window[:, 1:].copy(),
        }

    def batches(self, start_step: int, num: int):
        for s in range(start_step, start_step + num):
            yield s, self.batch(s)


def pad_labels(labels: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``labels`` with every position at or past row i's length set to
    ``LABEL_PAD``."""
    out = labels.copy()
    for i, L in enumerate(lengths):
        out[i, L:] = LABEL_PAD
    return out
