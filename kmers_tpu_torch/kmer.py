"""Kmer: an immutable, register-packed k-mer value type.

Counterpart of ``kmers_tpu/kmer.py``, copied whole (the port keeps its own
copy and imports nothing of the JAX package).  The scalar (one k-mer at a
time) layer: the API surface, the semantics contract, and the oracle for
the batched ops of ``kmers_tpu_torch.ops``; it favours bit-exact semantics
over speed.

Bit layout (Kmers.jl's src/kmer.jl:33-44): a K-mer over an alphabet with
``bps`` bits a symbol occupies ``B = K*bps`` coding bits of an
``N = ceil(B/64)``-word big-endian register; the first symbol sits in the
highest coding bits and the unused bits, the top bits of the first word,
are zero.  The register is one Python int ``value`` (< 2**B) whose 64-bit
limbs, most significant first, are the reference's ``NTuple{N, UInt}``
words.  So:

- integer comparison of ``value`` is lexicographic symbol comparison,
  which ``canonical`` depends on;
- ``fx_hash`` consumes the 64-bit limbs in order and gives the
  reference's hash values (its goldens are Kmers.jl's
  test/runtests.jl:901-914).

These 64-bit words are not the device plane's registers: ``convert.py``
packs 31 bases (62 bits) into each int64 word, and its ``n_words(K, bps)``
counts those.
"""

from __future__ import annotations

import numpy as np

from .alphabets import (
    Alphabet,
    AminoAcidAlphabet,
    DNAAlphabet2,
    DNAAlphabet4,
    NucleicAcidAlphabet,
    RNAAlphabet2,
    RNAAlphabet4,
)
from .genetic_codes import standard_genetic_code

__all__ = [
    "Kmer",
    "DNAKmer",
    "RNAKmer",
    "AAKmer",
    "DNACodon",
    "RNACodon",
    "mer",
    "fx_hash",
    "derive_words",
    "n_words",
    "Mer",
    "KmerType",
    "derive_type",
]

_M64 = (1 << 64) - 1
#: FxHash multiplier: typemax(UInt64)/pi (Kmers.jl's src/kmer.jl:218).
FX_CONSTANT = 0x517CC1B727220A95


def n_words(alphabet: Alphabet, K: int) -> int:
    """Number of 64-bit words in the register (reference ``nsize``/``derive_type``)."""
    return -(-(K * alphabet.bits_per_symbol) // 64)


def derive_words(alphabet: Alphabet, K: int, value: int) -> tuple:
    """64-bit limbs of the register, first (head) word first."""
    N = n_words(alphabet, K)
    return tuple((value >> (64 * (N - 1 - i))) & _M64 for i in range(N))


def _cmp_kind(alphabet: Alphabet) -> str:
    """Comparability class: kmers compare/equal only within a class.

    Same alphabet, or both 2-bit nucleotide, or both 4-bit nucleotide
    (Kmers.jl's src/kmer.jl:195-198).
    """
    if isinstance(alphabet, (DNAAlphabet2, RNAAlphabet2)):
        return "nuc2"
    if isinstance(alphabet, (DNAAlphabet4, RNAAlphabet4)):
        return "nuc4"
    return type(alphabet).__name__


class Kmer:
    """Immutable k-mer. Construct with ``Kmer(alphabet, source[, K=...])``.

    ``source`` may be a str/bytes (ASCII path), a :class:`~kmers_tpu_torch.seq.Seq`,
    another ``Kmer`` (recoding), or any iterable of symbols/chars.  ``K``
    defaults to ``len(source)`` and is validated against it, mirroring the
    reference's length check (Kmers.jl's src/construction.jl:207-276).
    """

    __slots__ = ("alphabet", "K", "value")

    def __init__(self, alphabet, source, K: int | None = None):
        from .construction import build_kmer_value  # deferred: avoids cycle

        if not isinstance(alphabet, Alphabet):
            alphabet = alphabet()
        value, k = build_kmer_value(alphabet, source, K)
        object.__setattr__(self, "alphabet", alphabet)
        object.__setattr__(self, "K", k)
        object.__setattr__(self, "value", value)

    def __setattr__(self, *_):
        raise AttributeError("Kmer is immutable")

    def __reduce__(self):
        # immutable __slots__ type: reconstruct via the unsafe constructor
        return (Kmer.unsafe, (self.alphabet, self.K, self.value))

    @classmethod
    def unsafe(cls, alphabet, K: int, value: int) -> "Kmer":
        """Wrap a pre-validated register value (reference's inner constructor)."""
        if not isinstance(alphabet, Alphabet):
            alphabet = alphabet()
        self = object.__new__(cls)
        object.__setattr__(self, "alphabet", alphabet)
        object.__setattr__(self, "K", K)
        object.__setattr__(self, "value", value)
        return self

    # -- geometry ------------------------------------------------------
    @property
    def bps(self) -> int:
        return self.alphabet.bits_per_symbol

    @property
    def bits(self) -> int:
        return self.K * self.bps

    @property
    def nsize(self) -> int:
        return n_words(self.alphabet, self.K)

    @property
    def capacity(self) -> int:
        """Symbols the register could hold (reference kmer.jl:131-133)."""
        per_word = 64 // self.bps
        return per_word * self.nsize

    @property
    def n_unused(self) -> int:
        return self.capacity - self.K

    @property
    def bits_unused(self) -> int:
        return self.n_unused * self.bps

    @property
    def words(self) -> tuple:
        return derive_words(self.alphabet, self.K, self.value)

    def _mask(self) -> int:
        return (1 << self.bits) - 1

    # -- container protocol --------------------------------------------
    def __len__(self):
        return self.K

    def __iter__(self):
        dec = self.alphabet.decode
        bps, K, v = self.bps, self.K, self.value
        m = (1 << bps) - 1
        return (dec((v >> ((K - 1 - i) * bps)) & m) for i in range(K))

    def extract_encoded_element(self, i: int) -> int:
        """0-based encoded element access (reference Kmers.jl's src/indexing.jl:1-8)."""
        if not 0 <= i < self.K:
            raise IndexError(i)
        return (self.value >> ((self.K - 1 - i) * self.bps)) & ((1 << self.bps) - 1)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self.K)
            if step == 1:
                k = max(0, stop - start)
                v = (self.value >> ((self.K - stop) * self.bps)) & ((1 << (k * self.bps)) - 1)
                return Kmer.unsafe(self.alphabet, k, v)
            idx = range(start, stop, step)
        elif isinstance(i, (list, tuple, np.ndarray)):
            arr = np.asarray(i)
            if arr.dtype == bool:
                if len(arr) != self.K:
                    raise IndexError("boolean mask length must equal K")
                idx = [j for j, b in enumerate(arr) if b]
            else:
                idx = [int(j) for j in arr]
        else:
            i = int(i)
            if i < 0:
                i += self.K
            return self.alphabet.decode(self.extract_encoded_element(i))
        v = 0
        for j in idx:
            if not -self.K <= j < self.K:
                raise IndexError(j)
            v = (v << self.bps) | self.extract_encoded_element(j % self.K)
        return Kmer.unsafe(self.alphabet, len(idx), v)

    def setindex(self, i: int, s) -> "Kmer":
        """Non-mutating single-symbol replacement (reference ``Base.setindex``)."""
        i = int(i)
        if i < 0:
            i += self.K
        if not 0 <= i < self.K:
            raise IndexError(i)
        enc = self.alphabet.encode(self.alphabet.coerce(s))
        sh = (self.K - 1 - i) * self.bps
        m = ((1 << self.bps) - 1) << sh
        return Kmer.unsafe(self.alphabet, self.K, (self.value & ~m) | (enc << sh))

    # -- comparison & hashing -------------------------------------------
    def _check_comparable(self, other):
        if not isinstance(other, Kmer):
            raise TypeError(f"cannot compare Kmer with {type(other).__name__}")
        if _cmp_kind(self.alphabet) != _cmp_kind(other.alphabet):
            raise TypeError(
                f"cannot compare kmers over {self.alphabet} and {other.alphabet}"
            )

    def cmp(self, other: "Kmer") -> int:
        """-1/0/1 three-way compare (Kmers.jl's src/kmer.jl:176-198)."""
        self._check_comparable(other)
        if self.K == other.K:
            a, b = self.value, other.value
        else:
            m = min(self.K, other.K)
            a = self.value >> ((self.K - m) * self.bps)
            b = other.value >> ((other.K - m) * other.bps)
            if a == b:
                return -1 if self.K < other.K else 1
        return (a > b) - (a < b)

    def __eq__(self, other):
        if isinstance(other, Kmer):
            return self.cmp(other) == 0
        if other is None or isinstance(other, (int, float, str)):
            return NotImplemented
        # Kmer == other-sequence-type deliberately errors (Kmers.jl's src/kmer.jl:203-204)
        raise TypeError(f"cannot compare Kmer with {type(other).__name__}")

    def __lt__(self, other):
        return self.cmp(other) < 0

    def __le__(self, other):
        return self.cmp(other) <= 0

    def __gt__(self, other):
        return self.cmp(other) > 0

    def __ge__(self, other):
        return self.cmp(other) >= 0

    def __hash__(self):
        # Must agree with __eq__ across the comparability class, mirroring
        # hash(x.data, h ⊻ K) (Kmers.jl's src/kmer.jl:206).
        return hash((_cmp_kind(self.alphabet), self.K, self.value))

    # -- display --------------------------------------------------------
    def __str__(self):
        return "".join(str(s) for s in self)

    def __repr__(self):
        name = self.alphabet.symbol_type.__name__ if self.alphabet.symbol_type is not str else "Char"
        return f"{name} {self.K}-mer: {self}"

    # -- integer round-trip ---------------------------------------------
    def as_integer(self):
        """Packed encoding in the smallest fitting unsigned type.

        Returns a NumPy unsigned scalar for <=64 bits, a Python int for
        65..128 bits; raises over 128 bits
        (Kmers.jl's src/kmer.jl:305-326).
        """
        if self.K == 0:
            return np.uint8(0)
        bits = self.bits
        if bits <= 8:
            return np.uint8(self.value)
        if bits <= 16:
            return np.uint16(self.value)
        if bits <= 32:
            return np.uint32(self.value)
        if bits <= 64:
            return np.uint64(self.value)
        if bits <= 128:
            return self.value
        raise ValueError("Must have at most 128 bits in encoding")

    @classmethod
    def from_integer(cls, alphabet, K: int, u) -> "Kmer":
        """Rebuild a kmer from ``as_integer`` output; masks to coding bits
        (Kmers.jl's src/kmer.jl:361-384)."""
        if not isinstance(alphabet, Alphabet):
            alphabet = alphabet()
        bits = K * alphabet.bits_per_symbol
        if bits > 128:
            raise ValueError("Kmer type must contain at most 128 bits")
        return cls.unsafe(alphabet, K, int(u) & ((1 << bits) - 1))

    # -- immutable mutation family --------------------------------------
    def _encode(self, s) -> int:
        return self.alphabet.encode(self.alphabet.coerce(s))

    def push(self, s) -> "Kmer":
        """K+1-mer with ``s`` appended (Kmers.jl's src/kmer.jl:409-423)."""
        return Kmer.unsafe(
            self.alphabet, self.K + 1, (self.value << self.bps) | self._encode(s)
        )

    def push_first(self, s) -> "Kmer":
        """K+1-mer with ``s`` prepended (Kmers.jl's src/kmer.jl:474-486)."""
        return Kmer.unsafe(
            self.alphabet, self.K + 1, (self._encode(s) << self.bits) | self.value
        )

    def shift(self, s) -> "Kmer":
        """Append ``s``, drop the first symbol (Kmers.jl's src/kmer.jl:445-448)."""
        return self.shift_encoding(self._encode(s))

    def shift_encoding(self, encoding: int) -> "Kmer":
        """Shift a pre-validated encoding in at the end
        (Kmers.jl's src/construction_utils.jl:129-134)."""
        if self.K == 0:
            return self
        return Kmer.unsafe(
            self.alphabet,
            self.K,
            ((self.value << self.bps) | encoding) & self._mask(),
        )

    def shift_first(self, s) -> "Kmer":
        """Prepend ``s``, drop the last symbol (Kmers.jl's src/kmer.jl:506-518)."""
        return self.shift_first_encoding(self._encode(s))

    def shift_first_encoding(self, encoding: int) -> "Kmer":
        if self.K == 0:
            return self
        return Kmer.unsafe(
            self.alphabet,
            self.K,
            (self.value >> self.bps) | (encoding << ((self.K - 1) * self.bps)),
        )

    def pop(self) -> "Kmer":
        """K-1-mer without the last symbol (Kmers.jl's src/kmer.jl:547-558)."""
        if self.K == 0:
            raise ValueError("Cannot pop 0-mer")
        return Kmer.unsafe(self.alphabet, self.K - 1, self.value >> self.bps)

    def pop_first(self) -> "Kmer":
        """K-1-mer without the first symbol (Kmers.jl's src/kmer.jl:587-599)."""
        if self.K == 0:
            raise ValueError("Cannot pop 0-mer")
        return Kmer.unsafe(
            self.alphabet, self.K - 1, self.value & ((1 << (self.bits - self.bps)) - 1)
        )

    # -- transformations -------------------------------------------------
    def reverse(self) -> "Kmer":
        """Reverse symbol order (Kmers.jl's src/transformations.jl:1-10)."""
        bps, m = self.bps, (1 << self.bps) - 1
        v, out = self.value, 0
        for _ in range(self.K):
            out = (out << bps) | (v & m)
            v >>= bps
        return Kmer.unsafe(self.alphabet, self.K, out)

    def complement(self) -> "Kmer":
        """Complement every symbol (Kmers.jl's src/transformations.jl:12-30)."""
        A = self.alphabet
        if not isinstance(A, NucleicAcidAlphabet):
            raise TypeError(f"cannot complement kmer over {A}")
        if A.bits_per_symbol == 2:
            return Kmer.unsafe(A, self.K, self.value ^ self._mask())
        if A.bits_per_symbol == 4:
            # reverse the bits of each nibble
            v, out = self.value, 0
            for i in range(self.K):
                nib = (v >> (4 * i)) & 0xF
                rev = ((nib & 1) << 3) | ((nib & 2) << 1) | ((nib & 4) >> 1) | ((nib & 8) >> 3)
                out |= rev << (4 * i)
            return Kmer.unsafe(A, self.K, out)
        # generic nucleotide fallback: re-encode symbol-wise
        # (Kmers.jl's src/transformations.jl:27-30)
        out = 0
        for s in self:
            out = (out << A.bits_per_symbol) | A.encode(s.complement())
        return Kmer.unsafe(A, self.K, out)

    def reverse_complement(self) -> "Kmer":
        return self.complement().reverse()

    def canonical(self) -> "Kmer":
        """min(self, reverse_complement) under the lexicographic order
        (Kmers.jl's src/transformations.jl:36-39)."""
        rc = self.reverse_complement()
        return self if self.value < rc.value else rc

    def iscanonical(self) -> bool:
        return self.value <= self.reverse_complement().value

    def translate(
        self,
        code=standard_genetic_code,
        allow_ambiguous_codons: bool = True,
        alternative_start: bool = False,
    ) -> "Kmer":
        """Translate a nucleotide kmer into an amino-acid kmer.

        Mirrors Kmers.jl's src/transformations.jl:43-103, except that
        ``alternative_start`` follows the (correct) LongSequence semantics of
        replacing the first amino acid with methionine; the reference's kmer
        path has an off-by-3 loop bound there that is only exercised by its
        orphaned test file.
        """
        A = self.alphabet
        if not isinstance(A, NucleicAcidAlphabet):
            raise TypeError(f"cannot translate kmer over {A}")
        aa_seq = self.to_seq().translate(
            code=code,
            allow_ambiguous_codons=allow_ambiguous_codons,
            alternative_start=alternative_start,
        )
        v = 0
        for c in aa_seq.codes:
            v = (v << 8) | int(c)
        return Kmer.unsafe(AminoAcidAlphabet(), len(aa_seq), v)

    # -- counting --------------------------------------------------------
    def count_gc(self) -> int:
        """Number of G/C/S symbols (2-bit: XOR-popcount trick,
        Kmers.jl's src/counting.jl:1-8)."""
        A = self.alphabet
        if not isinstance(A, NucleicAcidAlphabet):
            raise TypeError("count_gc is only defined for nucleotide kmers")
        if A.bits_per_symbol == 2:
            n = 0
            for w in self.words:
                n += bin((w ^ (w >> 1)) & 0x5555555555555555).count("1")
            return n
        return sum(1 for s in self if s.isGC)

    # -- conversions -----------------------------------------------------
    def to_seq(self):
        from .seq import Seq

        bps, m = self.bps, (1 << self.bps) - 1
        codes = np.fromiter(
            (
                (self.value >> ((self.K - 1 - i) * bps)) & m
                for i in range(self.K)
            ),
            dtype=np.uint8 if bps <= 8 else np.uint32,
            count=self.K,
        )
        return Seq.from_codes(self.alphabet, codes)

    def recode(self, alphabet) -> "Kmer":
        """Same sequence over another alphabet (reference ``Kmer{A1}(::Kmer{A2})``)."""
        return Kmer(alphabet, self)


def fx_hash(x: Kmer, h: int = 0) -> int:
    """FxHash of a kmer, bit-exact with the reference
    (Kmers.jl's src/kmer.jl:255-261; goldens test/runtests.jl:901-914)."""
    h &= _M64
    for w in x.words:
        rot = ((h << 5) | (h >> 59)) & _M64
        h = ((rot ^ w) * FX_CONSTANT) & _M64
    return h


# -- convenience constructors (reference type aliases, kmer.jl:72-88) ----
def DNAKmer(source, K: int | None = None) -> Kmer:
    return Kmer(DNAAlphabet2(), source, K)


def RNAKmer(source, K: int | None = None) -> Kmer:
    return Kmer(RNAAlphabet2(), source, K)


def AAKmer(source, K: int | None = None) -> Kmer:
    return Kmer(AminoAcidAlphabet(), source, K)


def DNACodon(source) -> Kmer:
    return Kmer(DNAAlphabet2(), source, 3)


def RNACodon(source) -> Kmer:
    return Kmer(RNAAlphabet2(), source, 3)


class _MerMeta(type):
    def __instancecheck__(cls, obj):
        K = getattr(cls, "_K", None)
        return isinstance(obj, Kmer) and (K is None or obj.K == K)

    def __getitem__(cls, K):
        return _MerMeta(f"Mer[{int(K)}]", (), {"_K": int(K)})


class Mer(metaclass=_MerMeta):
    """K-only kmer kind: ``isinstance(x, Mer[31])`` matches any alphabet's
    31-mer, ``isinstance(x, Mer)`` any kmer — the dispatch role of the
    reference's ``Mer{K} = Kmer{<:Alphabet,K}`` alias
    (Kmers.jl's src/kmer.jl:72)."""

    _K = None

    def __new__(cls, *_a, **_k):
        raise TypeError(
            "Mer is a dispatch kind, not a constructor; use Kmer(...) "
            "or derive_type(alphabet, K)(source)"
        )


class KmerType:
    """A fully derived kmer 'type': alphabet + K (+ word count N).

    The analogue of the reference's concrete ``Kmer{A,K,N}`` as produced
    by ``derive_type`` (Kmers.jl's src/kmer.jl:144-145): callable as
    a constructor, and carries the compile-time geometry.
    """

    __slots__ = ("alphabet", "K")

    def __init__(self, alphabet, K: int):
        if not isinstance(alphabet, Alphabet):
            alphabet = alphabet()
        if K < 0:
            raise ValueError("K must be >= 0")
        object.__setattr__(self, "alphabet", alphabet)
        object.__setattr__(self, "K", int(K))

    def __setattr__(self, *_):
        raise AttributeError("KmerType is immutable")

    @property
    def N(self) -> int:
        return n_words(self.alphabet, self.K)

    def __call__(self, source) -> Kmer:
        return Kmer(self.alphabet, source, self.K)

    def from_integer(self, u) -> Kmer:
        return Kmer.from_integer(self.alphabet, self.K, u)

    def zero(self) -> Kmer:
        """All-zero-encoding kmer (reference ``zero_kmer``, kmer.jl:147-152)."""
        return Kmer.unsafe(self.alphabet, self.K, 0)

    def __instancecheck__(self, obj):  # pragma: no cover - convenience
        return (
            isinstance(obj, Kmer)
            and obj.K == self.K
            and obj.alphabet == self.alphabet
        )

    def __eq__(self, other):
        return (
            isinstance(other, KmerType)
            and other.alphabet == self.alphabet
            and other.K == self.K
        )

    def __hash__(self):
        return hash((self.alphabet, self.K, "KmerType"))

    def __repr__(self):
        return f"KmerType({self.alphabet!r}, K={self.K}, N={self.N})"


def derive_type(alphabet, K: int) -> KmerType:
    """Derive the concrete kmer type for (alphabet, K)
    (Kmers.jl's src/kmer.jl:144-145)."""
    return KmerType(alphabet, K)


_MER_FLAGS = {
    "d": DNAAlphabet2,
    "dna": DNAAlphabet2,
    "r": RNAAlphabet2,
    "rna": RNAAlphabet2,
    "a": AminoAcidAlphabet,
    "aa": AminoAcidAlphabet,
}


def mer(s: str, flag: str = "d") -> Kmer:
    """``mer("TAG", "d")`` == the reference's ``mer"TAG"d`` literal
    (Kmers.jl's src/construction.jl:360-374)."""
    try:
        A = _MER_FLAGS[flag]
    except KeyError:
        raise ValueError(f"Invalid type flag: {flag!r}") from None
    return Kmer(A(), s)


# Kmer participates in the BioSequence kind (reference: Kmer <: BioSequence).
from .seq import BioSequence as _BioSequence  # noqa: E402  (leaf import, no cycle)

_BioSequence.register(Kmer)
