"""Alphabet handling for sequence indexing.

Conventions used across the library:

* Sequences are dense ``int32`` token arrays.
* Token id ``0`` is reserved for the sentinel ``$`` (lexicographically
  smallest, unique, and terminal).  Real symbols are ``>= 1``.
* ``encode_bytes`` maps raw bytes to ``byte + 1`` so that arbitrary binary
  text (Pizza&Chili corpora, UTF-8 English, protein FASTA, ...) fits the
  convention with alphabet size 257.
"""

from __future__ import annotations

import numpy as np

SENTINEL = 0

# Canonical biological alphabets (id 0 is the sentinel everywhere).
DNA = "ACGT"
PROTEIN = "ACDEFGHIKLMNPQRSTVWY"

BYTE_SIGMA = 257  # 256 byte values shifted by one + sentinel


def encode_bytes(data: bytes) -> np.ndarray:
    """Encode raw bytes as int32 tokens in [1, 256]."""
    return np.frombuffer(data, dtype=np.uint8).astype(np.int32) + 1


def decode_bytes(tokens: np.ndarray) -> bytes:
    """Inverse of :func:`encode_bytes`; drops any sentinel tokens."""
    tokens = np.asarray(tokens)
    tokens = tokens[tokens != SENTINEL]
    return (tokens - 1).astype(np.uint8).tobytes()


def encode_str(text: str, alphabet: str | None = None) -> np.ndarray:
    """Encode a string.  With ``alphabet`` given, ids are dense in
    [1, len(alphabet)]; otherwise byte encoding is used."""
    if alphabet is None:
        return encode_bytes(text.encode("utf-8"))
    lut = {c: i + 1 for i, c in enumerate(alphabet)}
    return np.array([lut[c] for c in text], dtype=np.int32)


def decode_str(tokens: np.ndarray, alphabet: str | None = None) -> str:
    if alphabet is None:
        return decode_bytes(tokens).decode("utf-8", errors="replace")
    tokens = np.asarray(tokens)
    return "".join(alphabet[t - 1] for t in tokens if t != SENTINEL)


def append_sentinel(tokens: np.ndarray) -> np.ndarray:
    """Append the terminal sentinel.  Raises if a sentinel is already
    present anywhere (it must be unique)."""
    tokens = np.asarray(tokens, dtype=np.int32)
    if tokens.size and tokens.min() <= SENTINEL:
        raise ValueError("input tokens must be >= 1 (0 is the sentinel)")
    return np.concatenate([tokens, np.array([SENTINEL], dtype=np.int32)])


def sigma_of(tokens: np.ndarray) -> int:
    """Smallest alphabet size covering ``tokens`` (includes the sentinel)."""
    return int(np.asarray(tokens).max()) + 1
