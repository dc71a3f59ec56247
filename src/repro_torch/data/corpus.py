"""Synthetic Pizza&Chili-style corpora + deterministic generation (a copy
of the JAX package's ``data/corpus.py``, token for token the same output).

The paper validates on PROTEINS / DNA / ENGLISH from Pizza&Chili [11]; the
generators produce statistically similar token streams (same alphabets,
newline-separated records, Zipf-ish word distribution for ENGLISH) from a
numpy ``SeedSequence``, so any run can regenerate any corpus.
"""

from __future__ import annotations

import numpy as np

NEWLINE = 11  # token id reserved for the record separator inside bio corpora


def dna(n: int, seed: int = 0) -> np.ndarray:
    """Gene-like DNA records: ACGT (ids 1..4) with newline separators."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD7A]))
    toks = rng.integers(1, 5, n).astype(np.int32)
    # records of ~1k bases
    rec = rng.integers(500, 1500)
    toks[np.arange(rec, n, rec)] = 5  # separator id 5
    return toks


def proteins(n: int, seed: int = 0) -> np.ndarray:
    """Swissprot-like protein records over the 20-letter alphabet."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x9B0]))
    # mildly non-uniform residue frequencies
    freq = rng.dirichlet(np.full(20, 5.0))
    toks = rng.choice(np.arange(1, 21), size=n, p=freq).astype(np.int32)
    rec = rng.integers(200, 600)
    toks[np.arange(rec, n, rec)] = 21
    return toks


def english(n: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed 'words' over bytes — Gutenberg-ish statistics.

    The reference's draws, in its order (the word table, then chunks of
    4096 words until the stream holds n tokens), with the stream assembled
    by one gather over a table of the words (each one's letters + 1 and a
    space) instead of a Python loop over the words."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xE16]))
    vocab_words = 2048
    ranks = np.arange(1, vocab_words + 1)
    p = (1.0 / ranks) / np.sum(1.0 / ranks)
    word_lens = rng.integers(2, 9, vocab_words)
    letters = [rng.integers(ord("a"), ord("z") + 1, L).astype(np.uint8)
               for L in word_lens]
    table = np.concatenate([np.append(w.astype(np.int32) + 1, ord(" ") + 1)
                            for w in letters]).astype(np.int32)
    lens = word_lens + 1
    starts = np.cumsum(lens) - lens
    chunks, total = [], 0
    while total < n:
        words = rng.choice(vocab_words, size=4096, p=p)
        chunks.append(words)
        total += int(lens[words].sum())
    words = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
    ends = np.cumsum(lens[words])
    words = words[:int(np.searchsorted(ends, n)) + 1]
    wl = lens[words].astype(np.int32)
    first = np.cumsum(wl, dtype=np.int64) - wl    # stream offset of a word
    # token t of the stream is table[starts[word] + t - first[word]]
    idx = np.repeat((starts[words] - first).astype(np.int32), wl)[:n]
    idx += np.arange(len(idx), dtype=np.int32)
    return table[idx]


GENERATORS = {"dna": dna, "proteins": proteins, "english": english}


def corpus(kind: str, n: int, seed: int = 0) -> np.ndarray:
    return GENERATORS[kind](n, seed)


def sigma_for(kind: str) -> int:
    return {"dna": 6, "proteins": 22, "english": 257}[kind]
