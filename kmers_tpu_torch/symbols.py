"""The port's error type for bytes that cannot be encoded, and the symbol
types its alphabets are made of.

Counterpart of ``kmers_tpu/symbols.py`` (the port keeps its own copy and
imports nothing of the JAX package), cut to what ``alphabets.py`` needs:
the interned ``DNA``, ``RNA`` and ``AminoAcid`` symbols with their
BioSymbols codes (nucleotides a 4-bit compat-bit code: A=0b0001, C=0b0010,
G=0b0100, T/U=0b1000, unions for the ambiguity codes, gap 0, N 0b1111;
amino acids 0x00..0x1b in the order ``ARNDCQEGHILKMFPSTWYVOUBJZX*-``).
"""

from __future__ import annotations

__all__ = ["DNA", "RNA", "AminoAcid", "NucleicAcid", "EncodeError"]


class EncodeError(ValueError):
    """Raised when a byte cannot be encoded in an alphabet: an invalid
    byte, or an ambiguous base where ambiguity is not skipped."""

    def __init__(self, alphabet: str, value):
        self.alphabet = alphabet
        self.value = value
        super().__init__(f"cannot encode {value!r} in {alphabet}")


class _Symbol:
    """Base for interned, immutable biological symbols."""

    __slots__ = ("code", "char")
    _instances: tuple = ()
    _by_char: dict = {}

    def __init__(self, code: int, char: str):
        object.__setattr__(self, "code", code)
        object.__setattr__(self, "char", char)

    def __setattr__(self, *_):
        raise AttributeError(f"{type(self).__name__} is immutable")

    def __reduce__(self):
        # interned singletons: reconstruct through the registry
        return (type(self).from_code, (self.code,))

    def __repr__(self):
        name = {"*": "Term", "-": "Gap"}.get(self.char, self.char)
        return f"{type(self).__name__}_{name}"

    def __str__(self):
        return self.char

    def __hash__(self):
        return hash((type(self).__name__, self.code))

    def __eq__(self, other):
        if isinstance(other, _Symbol):
            return type(self) is type(other) and self.code == other.code
        return NotImplemented

    def __lt__(self, other):
        if type(self) is type(other):
            return self.code < other.code
        return NotImplemented

    @classmethod
    def from_code(cls, code: int):
        return cls._instances[code]

    @classmethod
    def from_char(cls, c: str):
        try:
            return cls._by_char[c]
        except KeyError:
            raise EncodeError(cls.__name__, c) from None

    @classmethod
    def coerce(cls, x):
        """Convert a char or a symbol of a compatible type to this type."""
        if isinstance(x, cls):
            return x
        if isinstance(x, str) and len(x) == 1:
            return cls.from_char(x)
        if isinstance(x, _Symbol):
            return cls._coerce_symbol(x)
        raise EncodeError(cls.__name__, x)

    @classmethod
    def _coerce_symbol(cls, x):
        raise EncodeError(cls.__name__, x)


class _Nucleotide(_Symbol):
    """DNA and RNA: 4-bit compat-bit codes; one converts to the other."""

    __slots__ = ()

    @classmethod
    def _coerce_symbol(cls, x):
        if isinstance(x, _Nucleotide):
            return cls.from_code(x.code)
        raise EncodeError(cls.__name__, x)


class DNA(_Nucleotide):
    __slots__ = ()


class RNA(_Nucleotide):
    __slots__ = ()


#: the base of DNA and RNA symbols (the reference's ``NucleicAcid``)
NucleicAcid = _Nucleotide

for _cls, _chars in ((DNA, "-ACMGRSVTWYHKDBN"), (RNA, "-ACMGRSVUWYHKDBN")):
    _cls._instances = tuple(_cls(i, ch) for i, ch in enumerate(_chars))
    _cls._by_char = {}
    for _s in _cls._instances:
        _cls._by_char[_s.char] = _cls._by_char[_s.char.lower()] = _s
        setattr(_cls, "Gap" if _s.char == "-" else _s.char, _s)


class AminoAcid(_Symbol):
    __slots__ = ()


AminoAcid._instances = tuple(
    AminoAcid(i, ch) for i, ch in enumerate("ARNDCQEGHILKMFPSTWYVOUBJZX*-")
)
AminoAcid._by_char = {}
for _s in AminoAcid._instances:
    AminoAcid._by_char[_s.char] = _s
    if _s.char.isalpha():
        AminoAcid._by_char[_s.char.lower()] = _s
    setattr(AminoAcid, {"*": "Term", "-": "Gap"}.get(_s.char, _s.char), _s)
