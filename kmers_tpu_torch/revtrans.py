"""Reverse translation: the codon set of each amino acid, as a 64-bit mask.

Counterpart of ``kmers_tpu/revtrans.py::ReverseGeneticCode``, cut to the
one thing the port's ops use: its 27 codon-set masks.  Bit ``c`` of a
mask is set when codon ``c`` (the 6-bit integer of ``genetic_codes.py``)
belongs to the set.
"""

from __future__ import annotations

from .genetic_codes import AA_CHARS, GeneticCode, standard_genetic_code

__all__ = ["codon_set_masks"]

_AA = {ch: i for i, ch in enumerate(AA_CHARS)}
#: amino acids that reverse-translate: every code but the gap's
N_SETS = len(AA_CHARS) - 1

_UGA = 0b111000  # (U, G, A) = (3, 2, 0)
_UAG = 0b110010  # (U, A, G) = (3, 0, 2)


def codon_set_masks(code: GeneticCode = standard_genetic_code) -> tuple:
    """The 27 codon-set masks of ``code``, indexed by amino-acid code, as
    Python ints: each amino acid's codons; B, J and Z the unions of their
    two constituents (D|N, I|L, E|Q); X every codon that is not a stop;
    selenocysteine U {UGA} and pyrrolysine O {UAG}.  The gap has none."""
    sets = [0] * N_SETS
    not_stop = 0
    for codon in range(64):
        aa = code.aa_code(codon)
        sets[aa] |= 1 << codon
        if aa != _AA["*"]:
            not_stop |= 1 << codon
    for union, (a, b) in (("B", "DN"), ("J", "IL"), ("Z", "EQ")):
        sets[_AA[union]] = sets[_AA[a]] | sets[_AA[b]]
    sets[_AA["X"]] = not_stop
    sets[_AA["U"]] = 1 << _UGA
    sets[_AA["O"]] = 1 << _UAG
    return tuple(sets)
