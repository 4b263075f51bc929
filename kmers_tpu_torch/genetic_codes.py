"""Genetic codes: codon -> amino-acid translation tables.

Counterpart of ``kmers_tpu/genetic_codes.py``, copied whole (the port
keeps its own copy and imports nothing of the JAX package), with two
additions for the device plane: :data:`AA_CHARS` and
:func:`sixframe_tbl16`, which the translation ops and the six-frame
kernels read.

A codon is the 6-bit integer ``(a << 4) | (b << 2) | c`` of the 2-bit
codes (A=0, C=1, G=2, U/T=3) of its bases, the data word of an
``RNACodon`` (parity anchor: the ``reverse_translate(aa"KWCL")`` doctest,
Kmers.jl's src/revtrans.jl:157-199: AA_W is bit 58, UGG).  The tables come
from the published NCBI translation tables, which list amino acids in
TTT, TTC, TTA, TTG, CTT, ... order (bases T, C, A, G), remapped to the
A, C, G, U order of the codon integer.
"""

from __future__ import annotations

import numpy as np

from .symbols import _AA_CHARS, AminoAcid, RNA

__all__ = [
    "AA_CHARS",
    "GeneticCode",
    "standard_genetic_code",
    "ncbi_trans_table",
    "unambiguous_codon",
    "try_translate_ambiguous_codon",
    "TranslationError",
    "sixframe_tbl16",
]

#: the amino-acid alphabet; an amino acid's code is its index (``*`` is
#: the stop codon's symbol, ``-`` the gap)
AA_CHARS = _AA_CHARS


class TranslationError(ValueError):
    pass


# NCBI base-order digit (T=0, C=1, A=2, G=3) -> our 2-bit code (A=0,C=1,G=2,U=3)
_NCBI_TO_OURS = (3, 1, 0, 2)


class GeneticCode:
    """A 64-entry codon -> AminoAcid table.

    ``tbl`` is an np.uint8[64] of amino-acid codes indexed by the 6-bit codon
    encoding described in the module docstring.  Instances are immutable
    and hash by identity, so tables derived from a code can be cached per
    code.
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
            tbl[(b1 << 4) | (b2 << 2) | b3] = AminoAcid.from_char(ch).code
        tbl.setflags(write=False)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "tbl", tbl)

    def __setattr__(self, *_):
        raise AttributeError("GeneticCode is immutable")

    def __repr__(self):
        return f"GeneticCode({self.name!r})"

    def __getitem__(self, codon) -> AminoAcid:
        """codon: 6-bit int encoding, or an RNACodon-like with .as_int()."""
        idx = codon if isinstance(codon, int) else int(codon.as_integer())
        return AminoAcid.from_code(int(self.tbl[idx & 63]))

    def aa_code(self, codon_encoding: int) -> int:
        return int(self.tbl[codon_encoding & 63])


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


def unambiguous_codon(a: int, b: int, c: int) -> int:
    """Three 2-bit base codes -> 6-bit codon encoding.

    Mirrors ``BioSequences.unambiguous_codon`` as used at
    Kmers.jl's src/transformations.jl:63.
    """
    return ((a & 3) << 4) | ((b & 3) << 2) | (c & 3)


def _compat_codes(sym: RNA):
    """All 2-bit codes compatible with a (possibly ambiguous) nucleotide."""
    bits = sym.compatbits
    return [i for i in range(4) if bits & (1 << i)]


_AA_B = AminoAcid.B.code
_AA_J = AminoAcid.J.code
_AA_Z = AminoAcid.Z.code
_AA_X = AminoAcid.X.code
_B_SET = frozenset((AminoAcid.D.code, AminoAcid.N.code))
_J_SET = frozenset((AminoAcid.I.code, AminoAcid.L.code))
_Z_SET = frozenset((AminoAcid.E.code, AminoAcid.Q.code))


def try_translate_ambiguous_codon(
    code: GeneticCode, a: RNA, b: RNA, c: RNA, allow_ambiguous_codons: bool
) -> AminoAcid:
    """Translate a codon containing ambiguous nucleotides.

    Collect the set of amino acids produced by every compatible unambiguous
    codon; a singleton resolves exactly, {D,N} -> B, {I,L} -> J, {E,Q} -> Z,
    anything else -> X if ``allow_ambiguous_codons`` else an error.
    Mirrors ``BioSequences.try_translate_ambiguous_codon`` as used at
    Kmers.jl's src/transformations.jl:96.
    """
    aas = set()
    for ca in _compat_codes(a):
        for cb in _compat_codes(b):
            for cc in _compat_codes(c):
                aas.add(code.aa_code(unambiguous_codon(ca, cb, cc)))
    if len(aas) == 1:
        return AminoAcid.from_code(next(iter(aas)))
    if aas == _B_SET:
        return AminoAcid.from_code(_AA_B)
    if aas == _J_SET:
        return AminoAcid.from_code(_AA_J)
    if aas == _Z_SET:
        return AminoAcid.from_code(_AA_Z)
    if allow_ambiguous_codons:
        return AminoAcid.from_code(_AA_X)
    raise TranslationError(
        f"codon {a}{b}{c} cannot be unambiguously translated"
    )


# ---------------------------------------------------------------------------
# Published NCBI translation tables (transl_table numbers in comments).
# Base order of the strings: TTT, TTC, TTA, TTG, CTT, ... (T, C, A, G).
# ---------------------------------------------------------------------------

standard_genetic_code = GeneticCode(
    "Standard", "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
)  # 1
vertebrate_mitochondrial_genetic_code = GeneticCode(
    "Vertebrate Mitochondrial",
    "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
)  # 2
yeast_mitochondrial_genetic_code = GeneticCode(
    "Yeast Mitochondrial",
    "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 3
mold_mitochondrial_genetic_code = GeneticCode(
    "Mold Mitochondrial; Protozoan Mitochondrial; Coelenterate Mitochondrial; Mycoplasma; Spiroplasma",
    "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 4
invertebrate_mitochondrial_genetic_code = GeneticCode(
    "Invertebrate Mitochondrial",
    "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
)  # 5
ciliate_nuclear_genetic_code = GeneticCode(
    "Ciliate Nuclear; Dasycladacean Nuclear; Hexamita Nuclear",
    "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 6
echinoderm_mitochondrial_genetic_code = GeneticCode(
    "Echinoderm Mitochondrial; Flatworm Mitochondrial",
    "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
)  # 9
euplotid_nuclear_genetic_code = GeneticCode(
    "Euplotid Nuclear",
    "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 10
bacterial_plastid_genetic_code = GeneticCode(
    "Bacterial, Archaeal and Plant Plastid",
    "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 11
alternative_yeast_nuclear_genetic_code = GeneticCode(
    "Alternative Yeast Nuclear",
    "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 12
ascidian_mitochondrial_genetic_code = GeneticCode(
    "Ascidian Mitochondrial",
    "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
)  # 13
alternative_flatworm_mitochondrial_genetic_code = GeneticCode(
    "Alternative Flatworm Mitochondrial",
    "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
)  # 14
chlorophycean_mitochondrial_genetic_code = GeneticCode(
    "Chlorophycean Mitochondrial",
    "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 16
trematode_mitochondrial_genetic_code = GeneticCode(
    "Trematode Mitochondrial",
    "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
)  # 21
scenedesmus_obliquus_mitochondrial_genetic_code = GeneticCode(
    "Scenedesmus obliquus Mitochondrial",
    "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 22
thraustochytrium_mitochondrial_genetic_code = GeneticCode(
    "Thraustochytrium Mitochondrial",
    "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 23
pterobranchia_mitochondrial_genetic_code = GeneticCode(
    "Pterobranchia Mitochondrial",
    "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
)  # 24
#: alias matching BioSequences.jl's (typo'd) export name
pterobrachia_mitochondrial_genetic_code = pterobranchia_mitochondrial_genetic_code

candidate_division_sr1_genetic_code = GeneticCode(
    "Candidate Division SR1 and Gracilibacteria",
    "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
)  # 25

#: transl_table number -> GeneticCode, mirroring BioSequences.ncbi_trans_table.
ncbi_trans_table = {
    1: standard_genetic_code,
    2: vertebrate_mitochondrial_genetic_code,
    3: yeast_mitochondrial_genetic_code,
    4: mold_mitochondrial_genetic_code,
    5: invertebrate_mitochondrial_genetic_code,
    6: ciliate_nuclear_genetic_code,
    9: echinoderm_mitochondrial_genetic_code,
    10: euplotid_nuclear_genetic_code,
    11: bacterial_plastid_genetic_code,
    12: alternative_yeast_nuclear_genetic_code,
    13: ascidian_mitochondrial_genetic_code,
    14: alternative_flatworm_mitochondrial_genetic_code,
    16: chlorophycean_mitochondrial_genetic_code,
    21: trematode_mitochondrial_genetic_code,
    22: scenedesmus_obliquus_mitochondrial_genetic_code,
    23: thraustochytrium_mitochondrial_genetic_code,
    24: pterobranchia_mitochondrial_genetic_code,
    25: candidate_division_sr1_genetic_code,
}
