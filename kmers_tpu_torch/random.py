"""Random K-mers, on the host and on the device.

Counterpart of ``kmers_tpu/random.py``.  The host functions
(``rand_symbol``, ``rand_from_kmer``, ``rand_kmer``, ``rand_kmers``,
``rand_kmers_mw``) are copied whole: they take the same ``rng`` (``None``,
an int seed or a ``numpy.random.Generator``) and give the same values for
the same seed.  ``rand_kmers_device`` takes a ``torch.Generator`` in place
of a ``jax.random`` key, so its bits are not the reference's.  The
distribution rules are the reference's RandomExt (Kmers.jl's
ext/RandomExt.jl):

- 2-bit nucleotide alphabets (complete): uniform raw register bits;
- 4-bit nucleotide alphabets: uniform over the four unambiguous bases, as
  one-hot nibbles;
- amino acids: uniform over the 20 proteogenic amino acids;
- other alphabets (host functions only): uniform over their symbols.

``rand_kmers`` returns the scalar plane's registers (uint64, or Python
ints beyond 64 bits).  ``rand_kmers_device``'s follow ``convert.py``: one
int64 key for at most 62 bits, ``(n_words(K, bps), n)`` int64 words for
wider ones; bits above ``K * bps`` are zero.
"""

from __future__ import annotations

import numpy as np
import torch

from .alphabets import Alphabet, AminoAcidAlphabet, DNAAlphabet2, DNAAlphabet4, RNAAlphabet2, RNAAlphabet4
from .convert import KEY_BITS_MAX, n_words
from .kmer import Kmer
from .ops.windows import or_field

__all__ = [
    "PROTEOGENIC_AA",
    "rand_kmer",
    "rand_kmers",
    "rand_kmers_mw",
    "rand_kmers_device",
    "rand_symbol",
    "rand_from_kmer",
]

#: encodings of the 20 proteogenic amino acids (ACDEFGHIKLMNPQRSTVWY)
PROTEOGENIC_AA = tuple(AminoAcidAlphabet().encode(c) for c in "ACDEFGHIKLMNPQRSTVWY")


def _rng(rng):
    if rng is None:
        return np.random.default_rng()
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(int(rng))
    return rng


def rand_symbol(alphabet: Alphabet, rng=None):
    """One uniformly random symbol of the alphabet (rand(::Kmer) analogue
    samples positions; this samples the alphabet)."""
    rng = _rng(rng)
    if isinstance(alphabet, AminoAcidAlphabet):
        return alphabet.decode(int(rng.choice(PROTEOGENIC_AA)))
    syms = alphabet.symbols
    return syms[int(rng.integers(len(syms)))]


def rand_from_kmer(kmer: Kmer, rng=None):
    """One symbol drawn uniformly from the kmer's positions — the
    ``rand(rng, ::Kmer)`` method of the reference
    (Kmers.jl's ext/RandomExt.jl:40-44), which samples an *element
    of the sequence*, not the alphabet."""
    rng = _rng(rng)
    return kmer[int(rng.integers(len(kmer)))]


def rand_kmer(alphabet, K: int, rng=None) -> Kmer:
    """One random K-mer under the reference's distribution rules (any K,
    like the reference's any-N sampling — Kmers.jl's ext/RandomExt.jl:37-50)."""
    if not isinstance(alphabet, Alphabet):
        alphabet = alphabet()
    rng = _rng(rng)
    vals = rand_kmers(alphabet, K, 1, rng)
    return Kmer.unsafe(alphabet, K, int(vals[0]))


def _rand_encodings(alphabet, K: int, n: int, rng) -> np.ndarray:
    """(n, K) per-symbol encodings under the reference's distribution
    rules (Kmers.jl's ext/RandomExt.jl:56-109)."""
    if isinstance(alphabet, (DNAAlphabet2, RNAAlphabet2)):
        # complete alphabet: raw random coding bits == iid uniform symbols
        return rng.integers(0, 4, (n, K), dtype=np.uint64)
    if isinstance(alphabet, (DNAAlphabet4, RNAAlphabet4)):
        # uniform unambiguous bases as one-hot nibbles
        return np.uint64(1) << rng.integers(0, 4, (n, K), dtype=np.uint64)
    if isinstance(alphabet, AminoAcidAlphabet):
        return rng.choice(PROTEOGENIC_AA, size=(n, K)).astype(np.uint64)
    # incomplete/generic alphabet: sample symbols uniformly
    syms = alphabet.symbols
    enc_tbl = np.array([alphabet.encode(s) for s in syms], dtype=np.uint64)
    return enc_tbl[rng.integers(0, len(syms), (n, K))]


def rand_kmers(alphabet, K: int, n: int, rng=None) -> np.ndarray:
    """``n`` random K-mer register values.

    For K * bits_per_symbol <= 64 the result is a uint64 array; for wider
    kmers (the reference samples any-N kmers) it is an object-dtype array
    of Python ints, directly usable with :meth:`Kmer.unsafe` or
    convertible to the multiword limb plane via :func:`rand_kmers_mw`.
    """
    if not isinstance(alphabet, Alphabet):
        alphabet = alphabet()
    rng = _rng(rng)
    bps = alphabet.bits_per_symbol
    bits = K * bps
    if K == 0:
        return np.zeros(n, np.uint64)
    if bits <= 64 and isinstance(alphabet, (DNAAlphabet2, RNAAlphabet2)):
        # fast path: raw random coding bits, masked
        raw = rng.integers(0, 2**64, n, dtype=np.uint64)
        return raw & np.uint64((1 << bits) - 1)
    enc = _rand_encodings(alphabet, K, n, rng)
    if bits <= 64:
        out = np.zeros(n, np.uint64)
        for i in range(K):
            out = (out << np.uint64(bps)) | enc[:, i]
        return out
    # multi-word: pack into Python big ints (object dtype)
    out = np.array([0] * n, dtype=object)
    for i in range(K):
        out = (out << int(bps)) | enc[:, i].astype(object)
    return out


def rand_kmers_mw(alphabet, K: int, n: int, rng=None) -> np.ndarray:
    """``n`` random K-mers as (n, M) uint32 limb arrays (big-endian,
    limb 0 most significant, zero padding in the top bits of limb 0): the
    JAX package's multi-word layout, which ``convert.words_from_jax``
    turns into the port's device words."""
    if not isinstance(alphabet, Alphabet):
        alphabet = alphabet()
    bps = alphabet.bits_per_symbol
    bits = K * bps
    M = max(-(-bits // 32), 1)
    vals = rand_kmers(alphabet, K, n, rng)
    out = np.zeros((n, M), np.uint32)
    mask = (1 << 32) - 1
    for j in range(M - 1, -1, -1):
        out[:, j] = np.array(
            [(int(v) >> (32 * (M - 1 - j))) & mask for v in vals], np.uint32
        )
    return out


def rand_kmers_device(generator: torch.Generator, alphabet, K: int, n: int, device="cuda"):
    """``n`` random K-mer registers of ``alphabet`` made on ``device`` from
    ``generator`` (a ``torch.Generator`` of that device).

    Returns an ``(n,)`` int64 tensor when ``K * bits_per_symbol <= 62``,
    else ``(n_words(K, bps), n)`` int64 words.  Other alphabets raise
    ``NotImplementedError``, as in the reference.
    """
    if not isinstance(alphabet, Alphabet):
        alphabet = alphabet()
    device = torch.device(device)
    bps = alphabet.bits_per_symbol
    W = n_words(K, bps)

    def randint(high, size):
        return torch.randint(0, high, size, generator=generator, device=device)

    words = [torch.zeros(n, dtype=torch.int64, device=device) for _ in range(W)]
    if isinstance(alphabet, (DNAAlphabet2, RNAAlphabet2)):
        # complete alphabet: raw random bits, word 0 keeping what is left
        for p in range(W):
            bits = 2 * K - KEY_BITS_MAX * (W - 1) if p == 0 else KEY_BITS_MAX
            words[p] = randint(1 << bits, (n,))
    else:
        if isinstance(alphabet, (DNAAlphabet4, RNAAlphabet4)):
            codes = 1 << randint(4, (K, n))
        elif isinstance(alphabet, AminoAcidAlphabet):
            table = torch.tensor(PROTEOGENIC_AA, dtype=torch.int64, device=device)
            codes = table[randint(len(PROTEOGENIC_AA), (K, n))]
        else:
            raise NotImplementedError("device-side sampling supports nucleotide and AA alphabets")
        for i in range(K):
            or_field(words, codes[i], bps * (K - 1 - i), bps)
    return words[0] if W == 1 else torch.stack(words)
