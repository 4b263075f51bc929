"""Module-level function API mirroring the reference's exported verbs.

Counterpart of ``kmers_tpu/functions.py``, copied whole.  The reference
exports ``translate``, ``complement``, ``reverse_complement``,
``canonical`` and ``iscanonical`` as functions (re-exported from
BioSequences, Kmers.jl's src/Kmers.jl:56-76); this module gives the same
verbs over :class:`Kmer`, :class:`Seq` and symbols.
"""

from __future__ import annotations

from .kmer import Kmer

__all__ = [
    "translate",
    "complement",
    "reverse",
    "reverse_complement",
    "canonical",
    "iscanonical",
    "push",
    "push_first",
    "shift",
    "shift_first",
    "pop",
    "pop_first",
    "delete",
    "as_integer",
    "from_integer",
]


def translate(x, **kwargs):
    return x.translate(**kwargs)


def complement(x):
    return x.complement()


def reverse(x):
    return x.reverse()


def reverse_complement(x):
    return x.reverse_complement()


def canonical(x):
    return x.canonical()


def iscanonical(x) -> bool:
    return x.iscanonical()


def push(kmer: Kmer, s) -> Kmer:
    return kmer.push(s)


def push_first(kmer: Kmer, s) -> Kmer:
    return kmer.push_first(s)


def shift(kmer: Kmer, s) -> Kmer:
    return kmer.shift(s)


def shift_first(kmer: Kmer, s) -> Kmer:
    return kmer.shift_first(s)


def pop(kmer: Kmer) -> Kmer:
    return kmer.pop()


def pop_first(kmer: Kmer) -> Kmer:
    return kmer.pop_first()


def delete(codon_set, codon):
    """CodonSet element removal (the reference exports ``delete``)."""
    return codon_set.delete(codon)


def as_integer(kmer: Kmer):
    """Packed encoding in the smallest fitting unsigned type
    (Kmers.jl's src/kmer.jl:305-326)."""
    return kmer.as_integer()


def from_integer(kmer_type, u) -> Kmer:
    """Rebuild a kmer from its integer encoding.

    ``kmer_type`` is a :class:`~kmers_tpu_torch.kmer.KmerType` (from
    ``derive_type``) or an existing :class:`Kmer` used as the type template
    — the analogue of the reference's ``from_integer(typeof(k), u)``
    (Kmers.jl's src/kmer.jl:361-384)."""
    if isinstance(kmer_type, Kmer):
        return Kmer.from_integer(kmer_type.alphabet, kmer_type.K, u)
    return kmer_type.from_integer(u)
