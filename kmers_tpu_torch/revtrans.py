"""Reverse translation: CodonSet and ReverseGeneticCode.

Counterpart of ``kmers_tpu/revtrans.py``, copied whole (the port keeps its
own copy and imports nothing of the JAX package), with
:func:`codon_set_masks`, the 27 masks that ``ops/revtrans_ops.py`` reads
and that :class:`ReverseGeneticCode` wraps, so the device op and the
scalar plane share one definition.  Mirrors Kmers.jl's src/revtrans.jl.  A
codon's 6-bit packed encoding (the ``value`` of a 2-bit RNA 3-mer) is its
bit index in the 64-bit CodonSet mask; parity anchor:
``reverse_translate(aa"KWCL")`` yields masks 0x5, 0x0400000000000000,
0x0a00000000000000, 0x50000000f0000000 (Kmers.jl's
src/revtrans.jl:170-176).
"""

from __future__ import annotations

from .alphabets import RNAAlphabet2
from .genetic_codes import AA_CHARS, GeneticCode, standard_genetic_code
from .kmer import Kmer
from .seq import Seq
from .symbols import AminoAcid

__all__ = [
    "CodonSet",
    "ReverseGeneticCode",
    "rev_standard_genetic_code",
    "reverse_translate",
    "reverse_translate_into",
    "codon_set_masks",
]

_RNA2 = RNAAlphabet2()
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


def _as_codon(x) -> Kmer:
    if isinstance(x, Kmer):
        if x.K != 3:
            raise ValueError("CodonSet elements must be 3-mers")
        if not isinstance(x.alphabet, RNAAlphabet2):
            x = Kmer(_RNA2, x)
        return x
    return Kmer(_RNA2, x, 3)


class CodonSet:
    """Immutable set of RNA codons as a single uint64 bitmask
    (Kmers.jl's src/revtrans.jl:28-56)."""

    __slots__ = ("x",)

    def __init__(self, itr=()):
        m = 0
        for c in itr:
            m |= 1 << (_as_codon(c).value & 63)
        object.__setattr__(self, "x", m)

    def __setattr__(self, *_):
        raise AttributeError("CodonSet is immutable")

    def __reduce__(self):
        return (CodonSet.from_mask, (self.x,))

    @classmethod
    def from_mask(cls, mask: int) -> "CodonSet":
        self = object.__new__(cls)
        object.__setattr__(self, "x", mask & ((1 << 64) - 1))
        return self

    def __iter__(self):
        s = self.x
        while s:
            i = (s & -s).bit_length() - 1
            yield Kmer.unsafe(_RNA2, 3, i)
            s &= s - 1

    def __len__(self):
        return bin(self.x).count("1")

    def __contains__(self, c):
        return bool((self.x >> (_as_codon(c).value & 63)) & 1)

    def __eq__(self, other):
        if isinstance(other, CodonSet):
            return self.x == other.x
        if isinstance(other, (set, frozenset)):
            return set(self) == other
        return NotImplemented

    def __hash__(self):
        return hash(("CodonSet", self.x))

    def __repr__(self):
        return f"CodonSet with {len(self)} elements: {{{', '.join(str(c) for c in self)}}}"

    def push(self, c) -> "CodonSet":
        return CodonSet.from_mask(self.x | (1 << (_as_codon(c).value & 63)))

    def delete(self, c) -> "CodonSet":
        return CodonSet.from_mask(self.x & ~(1 << (_as_codon(c).value & 63)))

    def union(self, *others) -> "CodonSet":
        m = self.x
        for o in others:
            m |= o.x
        return CodonSet.from_mask(m)

    def intersect(self, *others) -> "CodonSet":
        m = self.x
        for o in others:
            m &= o.x
        return CodonSet.from_mask(m)

    def setdiff(self, *others) -> "CodonSet":
        m = 0
        for o in others:
            m |= o.x
        return CodonSet.from_mask(self.x & ~m)

    def symdiff(self, *others) -> "CodonSet":
        m = self.x
        for o in others:
            m ^= o.x
        return CodonSet.from_mask(m)

    def issubset(self, other: "CodonSet") -> bool:
        return self.x & ~other.x == 0

    def isdisjoint(self, other: "CodonSet") -> bool:
        return self.x & other.x == 0

    def filter(self, pred) -> "CodonSet":
        return CodonSet(c for c in self if pred(c))

    __or__ = union
    __and__ = intersect
    __sub__ = setdiff
    __xor__ = symdiff
    __le__ = issubset


class ReverseGeneticCode:
    """Amino acid -> CodonSet of codons translating to it
    (Kmers.jl's src/revtrans.jl:88-130).

    Special rules: ambiguous AAs B/J/Z are unions of their constituents,
    AA_X is every non-stop codon, selenocysteine U -> {UGA}, pyrrolysine
    O -> {UAG}; the gap cannot be reverse-translated.
    """

    __slots__ = ("name", "sets")

    def __init__(self, code: GeneticCode = standard_genetic_code):
        object.__setattr__(self, "name", code.name)
        object.__setattr__(
            self, "sets", tuple(CodonSet.from_mask(m) for m in codon_set_masks(code))
        )

    def __setattr__(self, *_):
        raise AttributeError("ReverseGeneticCode is immutable")

    def __getitem__(self, aa) -> CodonSet:
        aa = AminoAcid.coerce(aa)
        if aa.code >= N_SETS:  # gap
            raise ValueError(f"Cannot reverse translate element: {aa}")
        return self.sets[aa.code]

    def __len__(self):
        return len(self.sets)

    def __iter__(self):
        return (
            (AminoAcid.from_code(i), s) for i, s in enumerate(self.sets)
        )

    def __repr__(self):
        return f"ReverseGeneticCode({self.name!r})"


rev_standard_genetic_code = ReverseGeneticCode(standard_genetic_code)


def reverse_translate(s, code: ReverseGeneticCode = rev_standard_genetic_code):
    """AminoAcid -> CodonSet; amino-acid Seq/Kmer -> list[CodonSet]
    (Kmers.jl's src/revtrans.jl:157-199)."""
    if isinstance(s, (AminoAcid, str)):
        return code[s]
    if isinstance(s, (Seq, Kmer)):
        return [code[aa] for aa in s]
    return [code[aa] for aa in s]


def reverse_translate_into(
    dest: list, s, code: ReverseGeneticCode = rev_standard_genetic_code
) -> list:
    """Fill ``dest`` (a mutable list) with the CodonSets of ``s`` and return
    it — the reference's in-place ``reverse_translate!(v, seq)``, which
    resizes ``v`` to ``length(seq)``
    (Kmers.jl's src/revtrans.jl:157-193)."""
    dest[:] = (code[aa] for aa in s)
    return dest
