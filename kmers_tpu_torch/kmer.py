"""A minimal 2-bit DNA K-mer value: what the port's tables and CLI need.

Counterpart of the 2-bit DNA case of ``kmers_tpu/kmer.py::Kmer`` (the port
keeps its own copy and imports nothing of the JAX package).  The register
is one Python int of ``2K`` bits, first base in the highest bits (A=0,
C=1, G=2, T=3), so integer order is lexicographic base order, for any K.
"""

from __future__ import annotations

__all__ = ["Kmer"]

_BASES = "ACGT"


class Kmer:
    """Immutable 2-bit DNA K-mer; build one with :meth:`Kmer.unsafe`."""

    __slots__ = ("K", "value")

    def __init__(self, K: int, value: int):
        object.__setattr__(self, "K", K)
        object.__setattr__(self, "value", value)

    def __setattr__(self, *_):
        raise AttributeError("Kmer is immutable")

    @classmethod
    def unsafe(cls, K: int, value: int) -> "Kmer":
        """Wrap a register value of at most ``2K`` bits (not checked)."""
        return cls(K, int(value))

    def reverse_complement(self) -> "Kmer":
        v, out = self.value ^ ((1 << (2 * self.K)) - 1), 0
        for _ in range(self.K):
            out = (out << 2) | (v & 3)
            v >>= 2
        return Kmer(self.K, out)

    def canonical(self) -> "Kmer":
        """min(self, reverse complement) under the lexicographic order."""
        rc = self.reverse_complement()
        return self if self.value < rc.value else rc

    def __eq__(self, other):
        if not isinstance(other, Kmer):
            return NotImplemented
        return self.K == other.K and self.value == other.value

    def __hash__(self):
        return hash((self.K, self.value))

    def __str__(self):
        v, K = self.value, self.K
        return "".join(_BASES[(v >> (2 * (K - 1 - i))) & 3] for i in range(K))

    def __repr__(self):
        return f"DNA {self.K}-mer: {self}"
