"""Genetic codes: codon -> amino-acid translation tables.

Counterpart of ``kmers_tpu/genetic_codes.py`` (the port keeps its own copy
and imports nothing of the JAX package), cut to what six-frame counting
and the translation ops call: :class:`GeneticCode`, the published NCBI
tables and :func:`sixframe_tbl16`.

A codon is the 6-bit integer ``(a << 4) | (b << 2) | c`` of the 2-bit
codes (A=0, C=1, G=2, U/T=3) of its bases.  An amino acid is its index in
:data:`AA_CHARS`, the reference's amino-acid alphabet.  The NCBI strings
list amino acids in TTT, TTC, TTA, TTG, CTT, ... order (bases T, C, A, G)
and are remapped to the A, C, G, U order of the codon integer.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "AA_CHARS",
    "GeneticCode",
    "standard_genetic_code",
    "ncbi_trans_table",
    "sixframe_tbl16",
]

#: the amino-acid alphabet; an amino acid's code is its index (``*`` is
#: the stop codon's symbol, ``-`` the gap)
AA_CHARS = "ARNDCQEGHILKMFPSTWYVOUBJZX*-"

# NCBI base-order digit (T=0, C=1, A=2, G=3) -> 2-bit code (A=0, C=1, G=2, U=3)
_NCBI_TO_OURS = (3, 1, 0, 2)


class GeneticCode:
    """A 64-entry codon -> amino-acid table.

    ``tbl`` is a read-only ``np.uint8[64]`` of amino-acid codes indexed by
    the 6-bit codon integer.  Instances are immutable and hash by
    identity, so tables derived from a code can be cached per code.
    """

    __slots__ = ("name", "tbl")

    def __init__(self, name: str, ncbi_string: str):
        if len(ncbi_string) != 64:
            raise ValueError("NCBI translation string must have 64 characters")
        tbl = np.zeros(64, dtype=np.uint8)
        for ncbi_index, ch in enumerate(ncbi_string):
            b1 = _NCBI_TO_OURS[(ncbi_index >> 4) & 3]
            b2 = _NCBI_TO_OURS[(ncbi_index >> 2) & 3]
            b3 = _NCBI_TO_OURS[ncbi_index & 3]
            tbl[(b1 << 4) | (b2 << 2) | b3] = AA_CHARS.index(ch)
        tbl.setflags(write=False)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "tbl", tbl)

    def __setattr__(self, *_):
        raise AttributeError("GeneticCode is immutable")

    def __repr__(self):
        return f"GeneticCode({self.name!r})"

    def aa_code(self, codon: int) -> int:
        """The amino-acid code of a 6-bit codon integer."""
        return int(self.tbl[codon & 63])


def sixframe_tbl16(code: GeneticCode) -> tuple:
    """The six-frame kernels' dual table of ``code``: entry ``c`` is
    ``tbl[c] | tbl[revcomp(c)] << 8``, the forward amino acid in the low
    byte and that of the reverse-complement codon (the codon the opposite
    strand reads over the same three bases) in the high byte."""
    out = []
    for c in range(64):
        b0, b1, b2 = (c >> 4) & 3, (c >> 2) & 3, c & 3
        rc = ((b2 ^ 3) << 4) | ((b1 ^ 3) << 2) | (b0 ^ 3)
        out.append(code.aa_code(c) | (code.aa_code(rc) << 8))
    return tuple(out)


# ---------------------------------------------------------------------------
# Published NCBI translation tables (transl_table numbers in comments).
# Base order of the strings: TTT, TTC, TTA, TTG, CTT, ... (T, C, A, G).
# ---------------------------------------------------------------------------

standard_genetic_code = GeneticCode(
    "Standard", "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
)  # 1

_NCBI = {
    2: ("Vertebrate Mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG"),
    3: ("Yeast Mitochondrial",
        "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    4: ("Mold Mitochondrial; Protozoan Mitochondrial; Coelenterate Mitochondrial; "
        "Mycoplasma; Spiroplasma",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    5: ("Invertebrate Mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG"),
    6: ("Ciliate Nuclear; Dasycladacean Nuclear; Hexamita Nuclear",
        "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    9: ("Echinoderm Mitochondrial; Flatworm Mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG"),
    10: ("Euplotid Nuclear",
         "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    11: ("Bacterial, Archaeal and Plant Plastid",
         "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    12: ("Alternative Yeast Nuclear",
         "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    13: ("Ascidian Mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG"),
    14: ("Alternative Flatworm Mitochondrial",
         "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG"),
    16: ("Chlorophycean Mitochondrial",
         "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    21: ("Trematode Mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG"),
    22: ("Scenedesmus obliquus Mitochondrial",
         "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    23: ("Thraustochytrium Mitochondrial",
         "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
    24: ("Pterobranchia Mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG"),
    25: ("Candidate Division SR1 and Gracilibacteria",
         "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"),
}

#: transl_table number -> GeneticCode (the NCBI numbering)
ncbi_trans_table = {
    1: standard_genetic_code,
    **{number: GeneticCode(name, table) for number, (name, table) in _NCBI.items()},
}
