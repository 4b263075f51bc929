"""ASCII classification for the 2-bit nucleotide path, in plain torch.

Counterpart of ``kmers_tpu/ops/encode.py::classify_2bit``: the same
``((b >> 1) ^ (b >> 2)) & 3`` code identity on A/C/G/T/U (either case) and
the same letter-bitmask classes, so every byte value falls in the class
``alphabets.ASCII_SKIPPING_LUT`` gives it.
"""

from __future__ import annotations

import torch

__all__ = ["classify_2bit"]


def _letter_mask(letters: str) -> int:
    m = 0
    for c in letters:
        m |= 1 << (ord(c) - ord("A"))
    return m


# A, C, G, T and U are certain (T and U both code 3).
_CERTAIN_MASK = _letter_mask("ACGTU")
# IUPAC ambiguity letters (the skip class); '-' is handled separately.
_AMBIG_MASK = _letter_mask("MRSVWYHKDBN")


def classify_2bit(bytes_u8: torch.Tensor):
    """Classify a ``uint8`` tensor of ASCII bytes.

    Returns ``(codes, certain, ambiguous)``: ``codes`` int64, the 2-bit code
    (A=0, C=1, G=2, T/U=3; garbage where not certain); ``certain`` bool, an
    unambiguous base; ``ambiguous`` bool, an IUPAC ambiguity code or ``-``.
    A byte that is neither is invalid.
    """
    b = bytes_u8.to(torch.int64)
    codes = ((b >> 1) ^ (b >> 2)) & 3
    li = (b & 0xDF) - 65  # letter index after folding the ASCII case bit
    is_letter = (li >= 0) & (li < 26)
    safe = torch.where(is_letter, li, 0)
    certain = is_letter & (((_CERTAIN_MASK >> safe) & 1) == 1)
    ambig = (is_letter & (((_AMBIG_MASK >> safe) & 1) == 1)) | (b == ord("-"))
    return codes, certain, ambig
