"""ASCII classification and encoding of byte tensors, in plain torch.

Counterparts of ``kmers_tpu/ops/encode.py``:

- ``classify_2bit``: the same ``((b >> 1) ^ (b >> 2)) & 3`` code identity on
  A/C/G/T/U (either case) and the same letter-bitmask classes, so every
  byte value falls in the class ``alphabets.ASCII_SKIPPING_LUT`` gives it;
- ``encode_table``: bytes to an alphabet's codes.  The reference computes
  the table with letter-bitmask arithmetic because TPUs serialise random
  gathers; on the GPU the 256-entry table is one gather, with the same
  result for every byte.
"""

from __future__ import annotations

import functools

import torch

from ..alphabets import AminoAcidAlphabet, DNAAlphabet2, DNAAlphabet4, RNAAlphabet2, RNAAlphabet4

__all__ = ["classify_2bit", "encode_table"]

#: the alphabets with a byte table (the reference's ``_TABLES``)
_ALPHABETS = (DNAAlphabet2, RNAAlphabet2, DNAAlphabet4, RNAAlphabet4, AminoAcidAlphabet)


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


@functools.lru_cache(maxsize=None)
def _table(alphabet_cls, device: torch.device) -> torch.Tensor:
    if alphabet_cls not in _ALPHABETS:
        raise KeyError(alphabet_cls)
    return torch.tensor(alphabet_cls().ascii_table, dtype=torch.int64, device=device)


def encode_table(bytes_u8: torch.Tensor, alphabet_cls):
    """Encode a ``uint8`` tensor of ASCII bytes in an alphabet class
    (``DNAAlphabet2``, ``RNAAlphabet2``, ``DNAAlphabet4``, ``RNAAlphabet4``
    or ``AminoAcidAlphabet``; any other raises ``KeyError``, as in the
    reference).

    Returns ``(codes, valid)``: ``codes`` int64, the byte's code in the
    alphabet's ASCII table (either case), 0xFF where the byte has none;
    ``valid`` bool, the byte has a code.
    """
    codes = _table(alphabet_cls, bytes_u8.device)[bytes_u8.to(torch.int64)]
    return codes, codes != 0xFF
