"""Fused sort keys for the prefix-doubling build hot loop.

Every doubling round sorts ``(rank, rank[i+h])`` pairs with an index
payload.  The pair packs into the minimum number of 32-bit key words: one
word whenever ``bits(rank) + bits(rank2+1) <= 32`` (n <= 65535), two words
otherwise, so the sort moves one or two key operands plus one payload and
the radix engine knows how many significant bits each word carries.

Key words are stored as int32 and read as uint32 by every sort engine: a
word whose top bit is set (a q-gram key that fills all 32 bits, e.g.
sigma <= 4 at 2 bits x 16 fields) is negative as int32 but sorts last.

Pad semantics:

* Ranks are biased by +1 before packing so ``OVERFLOW_RANK`` (-1, the
  "suffix shorter than h" marker) packs to field value 0 and keeps sorting
  before every real rank.
* Pad keys are field-limited all-ones (``(1 << field_bits) - 1`` per
  word): the radix engine only sorts ``key_bits`` significant bits, so a
  pad must stay maximal within the field.  For pair keys the all-ones pad
  is strictly greater than any real key (``PairSpec.pad_words``); q-gram
  keys can saturate the field, and LSD-radix stability keeps appended pads
  last.

Also here: the packed q-gram initialiser.  ``qgram_params`` picks
``q = floor(32 / ceil(log2 sigma))`` characters per word; ranking suffixes
by that key replaces the first ``ceil(log2 q)`` doubling rounds.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels._bits import i32, u32


class PairSpec(NamedTuple):
    """Static packing layout for (rank, rank2) pairs of a length-n text."""

    n: int        # ranks r1 in [0, n-1]; r2 in [-1, n-1] (biased +1 on pack)
    words: int    # key words (1 = fused single word, 2 = hi/lo words)
    r1_bits: int  # significant bits of the r1 field
    r2_bits: int  # significant bits of the biased r2 field

    @property
    def key_bits(self) -> tuple[int, ...]:
        """Significant bits per key word, most-significant word first."""
        if self.words == 1:
            return (self.r1_bits + self.r2_bits,)
        return (self.r1_bits, self.r2_bits)

    def pad_words(self) -> tuple[int, ...]:
        """Field-limited all-ones pad per word (as unsigned values); sorts
        strictly after every real pair key (a real key would need n-1 and n
        both all-ones, which no n >= 2 satisfies)."""
        return tuple((1 << b) - 1 for b in self.key_bits)


def pair_spec(n: int) -> PairSpec:
    """Choose the packing for ranks of a length-``n`` text (static)."""
    if n < 2:
        return PairSpec(n, 1, 1, 1)
    r1_bits = (n - 1).bit_length()   # r1 <= n - 1
    r2_bits = n.bit_length()         # r2 + 1 <= n
    if r1_bits + r2_bits <= 32:
        return PairSpec(n, 1, r1_bits, r2_bits)
    return PairSpec(n, 2, r1_bits, r2_bits)


def pack_pairs(r1: torch.Tensor, r2: torch.Tensor, spec: PairSpec
               ) -> tuple[torch.Tensor, ...]:
    """(r1 int32 >= 0, r2 int32 >= -1) -> int32 key words, MSW first."""
    lo = r2 + 1
    if spec.words == 1:
        return (i32((r1.to(torch.int64) << spec.r2_bits) | lo),)
    return r1, lo


def unpack_pairs(words: tuple[torch.Tensor, ...], spec: PairSpec
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_pairs` (pad words unpack to garbage; callers
    mask by slot validity)."""
    if spec.words == 1:
        (w,) = words
        w = u32(w)
        r1 = (w >> spec.r2_bits).to(torch.int32)
        r2 = (w & ((1 << spec.r2_bits) - 1)).to(torch.int32) - 1
        return r1, r2
    hi, lo = words
    return hi, lo - 1


# ---------------------------------------------------------------------------
# packed q-gram init
# ---------------------------------------------------------------------------

def qgram_params(sigma: int, words: int = 2) -> tuple[int, int, int]:
    """(q, fields_per_word, bits_per_char) for a ``words``-word init key:
    each 32-bit word packs ``floor(32 / ceil(log2 sigma))`` characters."""
    bits = max(1, (max(2, sigma) - 1).bit_length())
    fpw = max(1, 32 // bits)
    return fpw * words, fpw, bits


def qgram_pad(fpw: int, bits: int) -> int:
    """Field-limited per-word pad for q-gram keys (NOT strictly greater
    than every real key; LSD-radix stability keeps appended pads last)."""
    return (1 << (fpw * bits)) - 1


def qgram_rounds_skipped(q: int) -> int:
    """Doubling rounds (h = 1, 2, ..) the q-char init makes unnecessary."""
    return max(0, math.ceil(math.log2(q))) if q > 1 else 0


def qgram_keys_local(s: torch.Tensor, fpw: int, bits: int, words: int = 1
                     ) -> tuple[torch.Tensor, ...]:
    """int32[n] key words per suffix (MSW first): the first ``words*fpw``
    chars packed big-endian, 0 (== sentinel) past the end.  Each word is
    assembled in int64 (one transient word per suffix) and stored back as
    the int32 bit pattern of its unsigned value."""
    n = s.shape[0]
    tail = torch.cat([s, torch.zeros(words * fpw, dtype=s.dtype,
                                     device=s.device)])
    out = []
    for w in range(words):
        v = torch.zeros(n, dtype=torch.int64, device=s.device)
        for j in range(w * fpw, (w + 1) * fpw):
            v = (v << bits) | tail[j: j + n]
        out.append(i32(v))
    return tuple(out)
