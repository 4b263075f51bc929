"""Alphabets: encoding and decoding between symbols and fixed-width bit codes.

Counterpart of ``kmers_tpu/alphabets.py``, copied as it is (the port keeps
its own copy and imports nothing of the JAX package); its symbols and
``EncodeError`` are the port's (``symbols.py``).  The encodings are the
reference's:

- ``DNAAlphabet2`` / ``RNAAlphabet2`` (2 bits a symbol): A=0b00, C=0b01,
  G=0b10, T/U=0b11; only unambiguous bases are encodable.
- ``DNAAlphabet4`` / ``RNAAlphabet4`` (4 bits a symbol): the symbol's 4-bit
  compat-bit code (one-hot for certain bases, unions for ambiguity codes).
- ``AminoAcidAlphabet`` (8 bits a symbol): BioSymbols codes 0x00..0x1b.

Each ASCII alphabet has a 256-entry byte table (``ascii_table``; invalid
bytes map to 0xff), which ``ops/encode.py::encode_table`` applies to byte
tensors.
"""

from __future__ import annotations

import numpy as np

from .symbols import DNA, RNA, AminoAcid, EncodeError

__all__ = [
    "Alphabet",
    "NucleicAcidAlphabet",
    "DNAAlphabet2",
    "DNAAlphabet4",
    "RNAAlphabet2",
    "RNAAlphabet4",
    "AminoAcidAlphabet",
    "CharAlphabet",
    "DNAAlphabet",
    "RNAAlphabet",
    "EncodeError",
    "ASCII_SKIPPING_LUT",
    "TWOBIT_ALPHABETS",
    "FOURBIT_ALPHABETS",
]


class Alphabet:
    """Base class. Alphabets are stateless singletons; ``A() is A()``."""

    bits_per_symbol: int
    symbol_type = None  # class of symbols, e.g. DNA
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return type(self).__name__

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self).__name__)

    # -- core interface -------------------------------------------------
    @property
    def symbols(self):
        """Tuple of all symbols, indexed by their encoding."""
        raise NotImplementedError

    def encode(self, symbol) -> int:
        """Symbol (or char) -> bit encoding. Raises EncodeError if invalid."""
        raise NotImplementedError

    def decode(self, encoding: int):
        """Bit encoding -> symbol."""
        raise NotImplementedError

    def coerce(self, x):
        """Convert char/symbol to this alphabet's symbol type."""
        return self.symbol_type.coerce(x)

    # -- ASCII support (AsciiAlphabet trait in the reference) -----------
    #: np.uint8[256]: byte -> encoding, 0xff = invalid. None if not ASCII.
    ascii_table: np.ndarray | None = None

    def ascii_encode(self, byte: int) -> int:
        t = self.ascii_table
        if t is None:
            raise EncodeError(self, byte)
        return int(t[byte])

    @property
    def is_complete(self) -> bool:
        """True if every bit pattern of width bits_per_symbol is a valid symbol."""
        return len(self.symbols) == (1 << self.bits_per_symbol)


def _ascii_table(pairs) -> np.ndarray:
    t = np.full(256, 0xFF, dtype=np.uint8)
    for chars, enc in pairs:
        for c in chars:
            t[ord(c)] = enc
            t[ord(c.lower())] = enc
    return t


class NucleicAcidAlphabet(Alphabet):
    pass


class DNAAlphabet2(NucleicAcidAlphabet):
    bits_per_symbol = 2
    symbol_type = DNA
    ascii_table = _ascii_table([("A", 0), ("C", 1), ("G", 2), ("T", 3)])

    @property
    def symbols(self):
        return (DNA.A, DNA.C, DNA.G, DNA.T)

    def encode(self, symbol) -> int:
        s = DNA.coerce(symbol)
        c = s.code
        if bin(c).count("1") != 1:
            raise EncodeError(self, s)
        return c.bit_length() - 1  # one-hot nibble -> 2-bit code (A=0,C=1,G=2,T=3)

    def decode(self, encoding: int):
        return self.symbols[encoding & 3]


class RNAAlphabet2(NucleicAcidAlphabet):
    bits_per_symbol = 2
    symbol_type = RNA
    ascii_table = _ascii_table([("A", 0), ("C", 1), ("G", 2), ("U", 3)])

    @property
    def symbols(self):
        return (RNA.A, RNA.C, RNA.G, RNA.U)

    def encode(self, symbol) -> int:
        s = RNA.coerce(symbol)
        c = s.code
        if bin(c).count("1") != 1:
            raise EncodeError(self, s)
        return c.bit_length() - 1

    def decode(self, encoding: int):
        return self.symbols[encoding & 3]


class DNAAlphabet4(NucleicAcidAlphabet):
    bits_per_symbol = 4
    symbol_type = DNA
    ascii_table = _ascii_table(
        [(ch, i) for i, ch in enumerate("-ACMGRSVTWYHKDBN")]
    )

    @property
    def symbols(self):
        return DNA._instances

    def encode(self, symbol) -> int:
        return DNA.coerce(symbol).code

    def decode(self, encoding: int):
        return DNA.from_code(encoding & 0xF)


class RNAAlphabet4(NucleicAcidAlphabet):
    bits_per_symbol = 4
    symbol_type = RNA
    ascii_table = _ascii_table(
        [(ch, i) for i, ch in enumerate("-ACMGRSVUWYHKDBN")]
    )

    @property
    def symbols(self):
        return RNA._instances

    def encode(self, symbol) -> int:
        return RNA.coerce(symbol).code

    def decode(self, encoding: int):
        return RNA.from_code(encoding & 0xF)


class AminoAcidAlphabet(Alphabet):
    bits_per_symbol = 8
    symbol_type = AminoAcid
    ascii_table = _ascii_table(
        [(ch, i) for i, ch in enumerate("ARNDCQEGHILKMFPSTWYVOUBJZX")]
        + [("*", 0x1A), ("-", 0x1B)]
    )

    @property
    def symbols(self):
        return AminoAcid._instances

    def encode(self, symbol) -> int:
        return AminoAcid.coerce(symbol).code

    def decode(self, encoding: int):
        if encoding > 0x1B:
            raise EncodeError(self, encoding)
        return AminoAcid.from_code(encoding)


def DNAAlphabet(bits: int) -> Alphabet:
    """Parametric alphabet lookup: ``DNAAlphabet(2)`` / ``DNAAlphabet(4)``
    (the reference's ``DNAAlphabet{N}`` type parameter)."""
    if bits == 2:
        return DNAAlphabet2()
    if bits == 4:
        return DNAAlphabet4()
    raise ValueError("DNAAlphabet bits must be 2 or 4")


def RNAAlphabet(bits: int) -> Alphabet:
    """Parametric alphabet lookup: ``RNAAlphabet(2)`` / ``RNAAlphabet(4)``."""
    if bits == 2:
        return RNAAlphabet2()
    if bits == 4:
        return RNAAlphabet4()
    raise ValueError("RNAAlphabet bits must be 2 or 4")


class CharAlphabet(Alphabet):
    """32-bit unicode-codepoint alphabet: an alphabet with no ASCII table,
    which forces the generic (non-specialized) code paths."""

    bits_per_symbol = 32
    symbol_type = str

    @property
    def symbols(self):
        raise NotImplementedError("CharAlphabet has 2^32 symbols")

    @property
    def is_complete(self) -> bool:
        return False

    def coerce(self, x):
        if isinstance(x, str) and len(x) == 1:
            return x
        raise EncodeError(self, x)

    def encode(self, symbol) -> int:
        return ord(self.coerce(symbol))

    def decode(self, encoding: int):
        return chr(encoding)


#: Byte classification LUT for ambiguity-skipping iteration over ASCII DNA/RNA.
#: 0-3 = 2-bit code, 0xf0 = ambiguous (skip window), 0xff = invalid (error);
#: ``ops/encode.py::classify_2bit`` computes the same classes.
ASCII_SKIPPING_LUT = np.full(256, 0xFF, dtype=np.uint8)
for _enc, _chars in ((0, "Aa"), (1, "cC"), (2, "gG"), (3, "TtUu")):
    for _c in _chars:
        ASCII_SKIPPING_LUT[ord(_c)] = _enc
for _c in "-MRSVWYHKDBN":
    ASCII_SKIPPING_LUT[ord(_c)] = 0xF0
    ASCII_SKIPPING_LUT[ord(_c.lower())] = 0xF0
ASCII_SKIPPING_LUT.setflags(write=False)

TWOBIT_ALPHABETS = (DNAAlphabet2, RNAAlphabet2)
FOURBIT_ALPHABETS = (DNAAlphabet4, RNAAlphabet4)
