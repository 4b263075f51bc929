"""Batched translation and six-frame amino-acid k-mer windows, in plain
torch.

Counterpart of ``kmers_tpu/ops/translate_ops.py``.  Codons are the
recombination of three consecutive 2-bit codes, the codon -> amino-acid
lookup an index into the code's 64-entry table (the JAX package's select
tree worked around slow gathers on the TPU; a GPU gathers from a table
this small at full speed), and amino-acid k-mers come from the window
registers at 8 bits a symbol.  Six-frame = frames 0/1/2 of the forward
stream, then frames 0/1/2 of the reverse-complement stream.
"""

from __future__ import annotations

import functools

import torch

from ..genetic_codes import GeneticCode, standard_genetic_code
from .windows import windows_from_codes

__all__ = [
    "codon_table",
    "translate_codes",
    "six_frame_codes",
    "aa_kmer_windows",
    "six_frame_aa_kmers",
]


@functools.lru_cache(maxsize=64)
def codon_table(code: GeneticCode, device) -> torch.Tensor:
    """``code``'s 64-entry codon -> amino-acid table as an int64 tensor on
    ``device`` (cached per code and device)."""
    return torch.tensor(code.tbl, dtype=torch.int64, device=device)


def translate_codes(codes: torch.Tensor, code: GeneticCode = standard_genetic_code):
    """2-bit nucleotide codes -> int64 amino-acid codes (frame 0; a
    trailing partial codon is dropped)."""
    c = codes.to(torch.int64)
    n_aa = c.shape[0] // 3
    c = c[: 3 * n_aa].reshape(n_aa, 3)
    codons = (c[:, 0] << 4) | (c[:, 1] << 2) | c[:, 2]
    return codon_table(code, c.device)[codons]


def six_frame_codes(codes: torch.Tensor, code: GeneticCode = standard_genetic_code):
    """The six amino-acid streams of a 2-bit code stream: frames +0, +1,
    +2 (forward), then -0, -1, -2 (the reverse-complement stream, the
    opposite strand read 5' to 3')."""
    rc = (codes.to(torch.int64) ^ 3).flip(0)
    return [translate_codes(codes[f:], code) for f in range(3)] + [
        translate_codes(rc[f:], code) for f in range(3)
    ]


def aa_kmer_windows(aa_codes: torch.Tensor, K: int) -> torch.Tensor:
    """Every K-window of an amino-acid code stream as an int64 register of
    8 bits a symbol, first symbol highest (K <= 8; at K = 8 a raw 64-bit
    pattern, as in ``convert.py``)."""
    return windows_from_codes(aa_codes, K, bps=8)


def six_frame_aa_kmers(codes: torch.Tensor, K: int, code: GeneticCode = standard_genetic_code):
    """Six-frame translated amino-acid K-mers: one int64 register stream
    per frame, in :func:`six_frame_codes` order."""
    return [aa_kmer_windows(aa, K) for aa in six_frame_codes(codes, code)]
