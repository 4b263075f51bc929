"""Random K-mer registers made on the device.

Counterpart of ``kmers_tpu/random.py::rand_kmers_device``, with a
``torch.Generator`` in place of a ``jax.random`` key, so its bits are not
the reference's; its distribution rules are (the reference's RandomExt):

- 2-bit nucleotide alphabets (complete): uniform raw register bits;
- 4-bit nucleotide alphabets: uniform over the four unambiguous bases, as
  one-hot nibbles;
- amino acids: uniform over the 20 proteogenic amino acids.

Registers follow ``convert.py``: one int64 key for at most 62 bits,
``(n_words(K, bps), n)`` int64 words for wider ones; bits above ``K *
bps`` are zero.
"""

from __future__ import annotations

import torch

from .alphabets import Alphabet, AminoAcidAlphabet, DNAAlphabet2, DNAAlphabet4, RNAAlphabet2, RNAAlphabet4
from .convert import KEY_BITS_MAX, n_words
from .ops.windows import or_field

__all__ = ["PROTEOGENIC_AA", "rand_kmers_device"]

#: encodings of the 20 proteogenic amino acids (ACDEFGHIKLMNPQRSTVWY)
PROTEOGENIC_AA = tuple(AminoAcidAlphabet().encode(c) for c in "ACDEFGHIKLMNPQRSTVWY")


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
