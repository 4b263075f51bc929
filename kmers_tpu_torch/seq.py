"""Seq: an element-wise encoded biological sequence backed by a NumPy array.

Counterpart of ``kmers_tpu/seq.py``, copied whole (the port keeps its own
copy and imports nothing of the JAX package).  The minimal
``LongSequence`` equivalent of the scalar plane: a conversion source and
target for kmers and an oracle for kmer operations.  A ``Seq`` stores one
encoding per array element (uint8 for alphabets of at most 8 bits, uint32
for the generic test alphabet), trading density for simplicity.
"""

from __future__ import annotations

import abc

import numpy as np

from .alphabets import (
    Alphabet,
    AminoAcidAlphabet,
    NucleicAcidAlphabet,
    EncodeError,
)
from .genetic_codes import (
    standard_genetic_code,
    try_translate_ambiguous_codon,
    unambiguous_codon,
    TranslationError,
)
from .symbols import RNA

__all__ = ["Seq", "BioSequence"]


class BioSequence(abc.ABC):
    """Abstract kind spanning every encoded sequence type (the reference's
    ``BioSequence`` supertype): ``isinstance(x, BioSequence)`` matches
    :class:`Seq` and :class:`~kmers_tpu_torch.kmer.Kmer`.  Not constructible."""

    def __new__(cls, *_a, **_k):
        raise TypeError("BioSequence is abstract; construct Seq or Kmer")


def _codes_dtype(alphabet: Alphabet):
    return np.uint8 if alphabet.bits_per_symbol <= 8 else np.uint32


class Seq:
    """Immutable element-wise encoded sequence over an :class:`Alphabet`."""

    __slots__ = ("alphabet", "codes")

    def __init__(self, alphabet: Alphabet, source=()):
        if not isinstance(alphabet, Alphabet):
            alphabet = alphabet()  # accept the class as well as the instance
        codes = self._encode_source(alphabet, source)
        codes.setflags(write=False)
        object.__setattr__(self, "alphabet", alphabet)
        object.__setattr__(self, "codes", codes)

    def __setattr__(self, *_):
        raise AttributeError("Seq is immutable")

    def __reduce__(self):
        return (Seq.from_codes, (self.alphabet, self.codes.copy()))

    @staticmethod
    def _encode_source(alphabet: Alphabet, source) -> np.ndarray:
        dtype = _codes_dtype(alphabet)
        if isinstance(source, Seq):
            if type(source.alphabet) is type(alphabet):
                return source.codes.copy()
            # recode symbol-wise
            return np.fromiter(
                (alphabet.encode(alphabet.coerce(s)) for s in source),
                dtype=dtype,
                count=len(source),
            )
        if isinstance(source, (str, bytes, bytearray, memoryview)):
            if isinstance(source, str):
                source = source.encode("utf-8") if alphabet.ascii_table is not None else source
            if alphabet.ascii_table is not None:
                arr = np.frombuffer(bytes(source), dtype=np.uint8)
                enc = alphabet.ascii_table[arr]
                bad = enc == 0xFF
                if bad.any():
                    raise EncodeError(alphabet, bytes(source)[int(np.argmax(bad))])
                return enc.astype(dtype)
            # non-ascii alphabet from a str: per-char encode
            return np.fromiter(
                (alphabet.encode(c) for c in source), dtype=dtype, count=len(source)
            )
        if isinstance(source, np.ndarray) and source.dtype == dtype:
            # already encoded; validate by decode round-trip for small alphabets
            return np.asarray(source, dtype=dtype).copy()
        items = list(source)
        return np.fromiter(
            (alphabet.encode(s) for s in items), dtype=dtype, count=len(items)
        )

    @classmethod
    def from_codes(cls, alphabet, codes: np.ndarray) -> "Seq":
        """Wrap pre-validated encodings without checking (unsafe fast path)."""
        if not isinstance(alphabet, Alphabet):
            alphabet = alphabet()
        self = object.__new__(cls)
        codes = np.asarray(codes, dtype=_codes_dtype(alphabet))
        codes.setflags(write=False)
        object.__setattr__(self, "alphabet", alphabet)
        object.__setattr__(self, "codes", codes)
        return self

    # -- basic container protocol --------------------------------------
    def __len__(self):
        return int(self.codes.shape[0])

    def __iter__(self):
        dec = self.alphabet.decode
        return (dec(int(c)) for c in self.codes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Seq.from_codes(self.alphabet, self.codes[i])
        if isinstance(i, (list, np.ndarray)):
            idx = np.asarray(i)
            if idx.dtype == bool:
                return Seq.from_codes(self.alphabet, self.codes[idx])
            return Seq.from_codes(self.alphabet, self.codes[idx])
        return self.alphabet.decode(int(self.codes[int(i)]))

    def __eq__(self, other):
        if isinstance(other, Seq):
            return (
                type(self.alphabet) is type(other.alphabet)
                and len(self) == len(other)
                and bool(np.array_equal(self.codes, other.codes))
            )
        return NotImplemented

    def __hash__(self):
        return hash((type(self.alphabet).__name__, self.codes.tobytes()))

    def __str__(self):
        return "".join(str(s) for s in self)

    def __repr__(self):
        return f"Seq({self.alphabet!r}, {str(self)!r})"

    # -- biological ops (oracles for the kmer and device paths) --------
    def complement(self) -> "Seq":
        A = self.alphabet
        if not isinstance(A, NucleicAcidAlphabet):
            raise TypeError(f"cannot complement sequence over {A}")
        if A.bits_per_symbol == 2:
            return Seq.from_codes(A, self.codes ^ 3)
        c = self.codes
        rev = ((c & 1) << 3) | ((c & 2) << 1) | ((c & 4) >> 1) | ((c & 8) >> 3)
        return Seq.from_codes(A, rev)

    def reverse(self) -> "Seq":
        return Seq.from_codes(self.alphabet, self.codes[::-1])

    def reverse_complement(self) -> "Seq":
        return self.complement().reverse()

    def canonical(self) -> "Seq":
        """Lexicographically smaller of self and its reverse complement
        (symbol order == encoding order for the standard alphabets)."""
        rc = self.reverse_complement()
        return self if self.codes.tobytes() <= rc.codes.tobytes() else rc

    def iscanonical(self) -> bool:
        return self.codes.tobytes() <= self.reverse_complement().codes.tobytes()

    def translate(
        self,
        code=standard_genetic_code,
        allow_ambiguous_codons: bool = True,
        alternative_start: bool = False,
    ) -> "Seq":
        """Translate a nucleotide Seq to an amino-acid Seq.

        Semantics mirror ``BioSequences.translate`` (used by the reference at
        Kmers.jl's src/transformations.jl:43-103): length must be a
        multiple of 3; 4-bit gaps error; ambiguous codons resolve via
        :func:`try_translate_ambiguous_codon`; ``alternative_start`` replaces
        the first amino acid with methionine.
        """
        A = self.alphabet
        if not isinstance(A, NucleicAcidAlphabet):
            raise TypeError(f"cannot translate sequence over {A}")
        n_aa, rem = divmod(len(self), 3)
        if rem:
            raise TranslationError("sequence length is not divisible by three")
        out = np.zeros(n_aa, dtype=np.uint8)
        two_bit = A.bits_per_symbol == 2
        for i in range(n_aa):
            a, b, c = (int(x) for x in self.codes[3 * i : 3 * i + 3])
            if two_bit:
                aa = code.aa_code(unambiguous_codon(a, b, c))
            else:
                ra, rb, rc = (RNA.from_code(x) for x in (a, b, c))
                if ra.isgap or rb.isgap or rc.isgap:
                    raise TranslationError(
                        "cannot translate nucleotide sequences with gaps"
                    )
                if ra.iscertain and rb.iscertain and rc.iscertain:
                    aa = code.aa_code(
                        unambiguous_codon(
                            ra.code.bit_length() - 1,
                            rb.code.bit_length() - 1,
                            rc.code.bit_length() - 1,
                        )
                    )
                else:
                    aa = try_translate_ambiguous_codon(
                        code, ra, rb, rc, allow_ambiguous_codons
                    ).code
            out[i] = aa
        if alternative_start and n_aa:
            out[0] = 0x0C  # AA_M
        return Seq.from_codes(AminoAcidAlphabet(), out)


BioSequence.register(Seq)
