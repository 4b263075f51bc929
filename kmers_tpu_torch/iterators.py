"""Scalar k-mer iterators: the semantic contract of the window kernels.

Counterpart of ``kmers_tpu/iterators.py``, copied whole (the port keeps
its own copy and imports nothing of the JAX package).  Mirrors Kmers.jl's
src/iterators/ (FwKmers, FwRvIterator, CanonicalKmers, UnambiguousKmers,
SpacedKmers).  Each iterator rolls a kmer one symbol at a time (O(1) work
per output, never re-extracting), like the reference's ``shift_encoding``
loops.

Differences from the reference (API decisions of the JAX package):
- positions are 0-based (the reference is 1-based Julia);
- iterators take ``(alphabet, K, source)`` instead of type parameters.
"""

from __future__ import annotations

from .alphabets import (
    Alphabet,
    AminoAcidAlphabet,
    ASCII_SKIPPING_LUT,
    DNAAlphabet2,
    NucleicAcidAlphabet,
    RNAAlphabet2,
    EncodeError,
)
from .construction import (
    AsciiEncode,
    Copyable,
    FourToTwo,
    TwoToFour,
    recoding_scheme,
    _ascii_bytes,
)
from .kmer import Kmer
from .seq import Seq

__all__ = [
    "AbstractKmerIterator",
    "FwKmers",
    "FwDNAMers",
    "FwRNAMers",
    "FwAAMers",
    "FwRvIterator",
    "CanonicalKmers",
    "CanonicalDNAMers",
    "CanonicalRNAMers",
    "UnambiguousKmers",
    "UnambiguousDNAMers",
    "UnambiguousRNAMers",
    "SpacedKmers",
    "SpacedDNAMers",
    "SpacedRNAMers",
    "SpacedAAMers",
    "each_codon",
]

_TWOBIT = (DNAAlphabet2, RNAAlphabet2)

# classification kinds for the unified encoding stream
_OK, _SKIP = 0, 1


def _stream(alphabet: Alphabet, source, skipping: bool):
    """Yield (encoding, kind) pairs for every element of ``source``.

    kind == _SKIP flags symbols that an ambiguity-skipping iterator should
    treat as window restarts; when ``skipping`` is False such symbols raise
    (FwKmers semantics: Kmers.jl's src/iterators/FwKmers.jl:104-129 vs
    UnambiguousKmers.jl:88-148).  Lazy: errors surface only when reached.
    """
    scheme = recoding_scheme(alphabet, source)
    bps = alphabet.bits_per_symbol

    if isinstance(scheme, AsciiEncode):
        data = _ascii_bytes(source)
        if skipping and bps == 2:
            lut = ASCII_SKIPPING_LUT
            for b in data:
                e = int(lut[b])
                if e == 0xFF:
                    raise EncodeError(alphabet, b)
                yield (0, _SKIP) if e == 0xF0 else (e, _OK)
        else:
            table = alphabet.ascii_table
            for b in data:
                e = int(table[b])
                if e > 0x7F:
                    raise EncodeError(alphabet, b)
                yield e, _OK
        return

    if isinstance(scheme, Copyable):
        codes = source.codes if isinstance(source, Seq) else None
        if codes is not None:
            for c in codes:
                yield int(c), _OK
        else:
            for i in range(len(source)):
                yield source.extract_encoded_element(i), _OK
        return

    if isinstance(scheme, FourToTwo):
        for i in range(len(source)):
            e = (
                int(source.codes[i])
                if isinstance(source, Seq)
                else source.extract_encoded_element(i)
            )
            if bin(e).count("1") == 1:
                yield e.bit_length() - 1, _OK
            elif skipping:
                yield 0, _SKIP
            else:
                raise EncodeError(alphabet, source.alphabet.decode(e))
        return

    if isinstance(scheme, TwoToFour):
        for i in range(len(source)):
            e = (
                int(source.codes[i])
                if isinstance(source, Seq)
                else source.extract_encoded_element(i)
            )
            yield 1 << e, _OK
        return

    # GenericRecoding: iterate symbols
    for s in source:
        sym = alphabet.coerce(s)
        if skipping and getattr(sym, "isambiguous", False):
            yield 0, _SKIP
        else:
            yield alphabet.encode(sym), _OK


class AbstractKmerIterator:
    """Common base (Kmers.jl's src/iterators/common.jl:1-15)."""

    alphabet: Alphabet
    K: int

    def _source_len(self) -> int:
        src = self.seq
        if isinstance(src, str):
            return len(src.encode("utf-8")) if self.alphabet.ascii_table is not None else len(src)
        return len(src)


def _check_k(K):
    if not isinstance(K, int) or K < 1:
        raise ValueError("K must be an Int >= 1")


class FwKmers(AbstractKmerIterator):
    """Every consecutive kmer, step 1 (Kmers.jl's src/iterators/FwKmers.jl)."""

    def __init__(self, alphabet, K: int, seq):
        _check_k(K)
        self.alphabet = alphabet() if not isinstance(alphabet, Alphabet) else alphabet
        self.K = K
        self.seq = seq

    def __len__(self):
        return max(0, self._source_len() - self.K + 1)

    def __iter__(self):
        A, K = self.alphabet, self.K
        kmer = Kmer.unsafe(A, K, 0)
        filled = 0
        for enc, _ in _stream(A, self.seq, skipping=False):
            kmer = kmer.shift_encoding(enc)
            filled += 1
            if filled >= K:
                yield kmer


class FwRvIterator(AbstractKmerIterator):
    """(forward, reverse_complement) 2-tuples, both rolled incrementally
    (Kmers.jl's src/iterators/CanonicalKmers.jl:25-174)."""

    def __init__(self, alphabet, K: int, seq):
        _check_k(K)
        self.alphabet = alphabet() if not isinstance(alphabet, Alphabet) else alphabet
        if not isinstance(self.alphabet, NucleicAcidAlphabet):
            raise TypeError("FwRvIterator requires a nucleic-acid alphabet")
        self.K = K
        self.seq = seq

    def __len__(self):
        return max(0, self._source_len() - self.K + 1)

    def __iter__(self):
        A, K = self.alphabet, self.K
        two_bit = A.bits_per_symbol == 2
        fw = Kmer.unsafe(A, K, 0)
        rv = Kmer.unsafe(A, K, 0)
        filled = 0
        for enc, _ in _stream(A, self.seq, skipping=False):
            fw = fw.shift_encoding(enc)
            if two_bit:
                rc = enc ^ 0b11
            else:
                c = enc
                rc = ((c & 1) << 3) | ((c & 2) << 1) | ((c & 4) >> 1) | ((c & 8) >> 3)
            rv = rv.shift_first_encoding(rc)
            filled += 1
            if filled >= K:
                yield fw, rv


class CanonicalKmers(AbstractKmerIterator):
    """min(fw, reverse_complement) per position — THE strand-neutral
    counting iterator (Kmers.jl's src/iterators/CanonicalKmers.jl:199-226)."""

    def __init__(self, alphabet, K: int, seq):
        self.it = FwRvIterator(alphabet, K, seq)
        self.alphabet = self.it.alphabet
        self.K = K
        self.seq = seq

    def __len__(self):
        return len(self.it)

    def __iter__(self):
        for fw, rv in self.it:
            yield fw if fw.value < rv.value else rv


class UnambiguousKmers(AbstractKmerIterator):
    """(kmer, start) pairs over 2-bit targets, skipping windows that contain
    ambiguous nucleotides (Kmers.jl's src/iterators/UnambiguousKmers.jl).

    ``start`` is the 0-based start position of the window in the source.
    """

    def __init__(self, alphabet, K: int, seq):
        _check_k(K)
        self.alphabet = alphabet() if not isinstance(alphabet, Alphabet) else alphabet
        if not isinstance(self.alphabet, _TWOBIT):
            raise TypeError("UnambiguousKmers requires a 2-bit nucleic-acid alphabet")
        self.K = K
        self.seq = seq

    def __len__(self):
        # Known only when the source's encoding cannot contain ambiguity
        # (2-bit sources), mirroring IteratorSize == HasLength for those
        # (Kmers.jl's src/iterators/UnambiguousKmers.jl:33-37).
        src = self.seq
        src_alpha = (
            src.alphabet if isinstance(src, (Seq, Kmer)) else None
        )
        if isinstance(src_alpha, _TWOBIT):
            return max(self._source_len() - self.K + 1, 0)
        raise TypeError(
            "length of UnambiguousKmers is unknown for sources that may "
            "contain ambiguous symbols (SizeUnknown in the reference)"
        )

    def __iter__(self):
        A, K = self.alphabet, self.K
        kmer = Kmer.unsafe(A, K, 0)
        remaining = K
        for i, (enc, kind) in enumerate(_stream(A, self.seq, skipping=True)):
            if kind == _SKIP:
                remaining = K
            else:
                kmer = kmer.shift_encoding(enc)
                remaining -= 1
                if remaining <= 0:
                    remaining = 0
                    yield kmer, i - K + 1


class SpacedKmers(AbstractKmerIterator):
    """Kmers at a fixed step J (Kmers.jl's src/iterators/SpacedKmers.jl).

    Samples windows starting at 0, J, 2J, ...; when J < K consecutive
    windows overlap and are rolled, when J >= K each is extracted fresh —
    semantically identical either way.
    """

    def __init__(self, alphabet, K: int, seq, J: int):
        _check_k(K)
        if not isinstance(J, int) or J < 1:
            raise ValueError("J must be an Int >= 1")
        self.alphabet = alphabet() if not isinstance(alphabet, Alphabet) else alphabet
        self.K = K
        self.J = J
        self.seq = seq

    def __len__(self):
        L = self._source_len()
        return 0 if L < self.K else (L - self.K) // self.J + 1

    def __iter__(self):
        A, K, J = self.alphabet, self.K, self.J
        if J >= K:
            # Fresh extraction per window: symbols in the gaps between
            # windows are never read, hence never validated — matching
            # Kmers.jl's src/iterators/SpacedKmers.jl:121-139.
            from .construction import unsafe_extract

            src = (
                _ascii_bytes(self.seq)
                if isinstance(self.seq, (str, bytes, bytearray, memoryview))
                else self.seq
            )
            scheme = recoding_scheme(A, src)
            L = len(src)
            for start in range(0, L - K + 1, J):
                yield unsafe_extract(scheme, A, K, src, start)
            return
        kmer = Kmer.unsafe(A, K, 0)
        filled = 0
        for i, (enc, _) in enumerate(_stream(A, self.seq, skipping=False)):
            kmer = kmer.shift_encoding(enc)
            filled += 1
            if filled >= K and (i - K + 1) % J == 0:
                yield kmer


# -- aliases (reference FwDNAMers etc.) ---------------------------------
def FwDNAMers(K, seq):
    return FwKmers(DNAAlphabet2(), K, seq)


def FwRNAMers(K, seq):
    return FwKmers(RNAAlphabet2(), K, seq)


def FwAAMers(K, seq):
    return FwKmers(AminoAcidAlphabet(), K, seq)


def CanonicalDNAMers(K, seq):
    return CanonicalKmers(DNAAlphabet2(), K, seq)


def CanonicalRNAMers(K, seq):
    return CanonicalKmers(RNAAlphabet2(), K, seq)


def UnambiguousDNAMers(K, seq):
    return UnambiguousKmers(DNAAlphabet2(), K, seq)


def UnambiguousRNAMers(K, seq):
    return UnambiguousKmers(RNAAlphabet2(), K, seq)


def SpacedDNAMers(K, J, seq):
    return SpacedKmers(DNAAlphabet2(), K, seq, J)


def SpacedRNAMers(K, J, seq):
    return SpacedKmers(RNAAlphabet2(), K, seq, J)


def SpacedAAMers(K, J, seq):
    return SpacedKmers(AminoAcidAlphabet(), K, seq, J)


def each_codon(kind, seq=None):
    """Nucleotide 3-mers with step 3 (Kmers.jl's src/iterators/SpacedKmers.jl:55-81).

    ``each_codon(DNA, s)`` / ``each_codon(RNA, s)`` for byte-like sources,
    or ``each_codon(seq)`` for a nucleotide :class:`Seq`.
    """
    from .symbols import DNA, RNA

    if seq is None:
        seq_ = kind
        if not isinstance(seq_, Seq) or not isinstance(
            seq_.alphabet, NucleicAcidAlphabet
        ):
            raise TypeError("each_codon(seq) requires a nucleotide Seq")
        A = DNAAlphabet2() if seq_.alphabet.symbol_type is DNA else RNAAlphabet2()
        return SpacedKmers(A, 3, seq_, 3)
    if kind is DNA:
        return SpacedKmers(DNAAlphabet2(), 3, seq, 3)
    if kind is RNA:
        return SpacedKmers(RNAAlphabet2(), 3, seq, 3)
    raise TypeError("each_codon kind must be DNA or RNA")
