"""Batched seed-0 FxHash of single-word registers, as int64 order keys.

Counterpart of ``kmers_tpu/ops/hashing.py::fx_hash_u64``.  The FxHash of
one 64-bit word with seed 0 is ``(0 rotl 5) ^ w == w`` times the constant,
so ``w * FX mod 2^64``: torch's int64 ``*`` wraps mod 2^64, so one multiply
gives the hash's bits.  The result is the hash's order key (the sign bit
flipped, ``convert.py``), so that signed order is the JAX package's
unsigned order.  :func:`fx_hash_words` is the reference's FxHash of a
sequence of 64-bit words, whose raw bits chain from one call to the next.
"""

from __future__ import annotations

import torch

from ..convert import SIGN_BIT

__all__ = ["FX_CONSTANT", "fx_hash_u64", "fx_hash_words"]

#: FxHash's multiplier (``kmers_tpu/kmer.py::FX_CONSTANT``); below 2^63,
#: so it is an int64 as it stands
FX_CONSTANT = 0x517CC1B727220A95


def fx_hash_u64(regs: torch.Tensor) -> torch.Tensor:
    """Order keys of the seed-0 FxHash of int64 registers (any 64-bit
    pattern, K = 32 included): ``(regs * FX mod 2^64) ^ (1 << 63)``."""
    return (regs * FX_CONSTANT) ^ SIGN_BIT


def _rotl5(h: torch.Tensor) -> torch.Tensor:
    # the arithmetic right shift drags the sign along: mask it off
    return (h << 5) | ((h >> 59) & 0x1F)


def fx_hash_words(words, h: torch.Tensor | None = None) -> torch.Tensor:
    """FxHash over a sequence of int64 tensors of 64-bit words (raw bit
    patterns), head word first: ``h = ((h rotl 5) ^ word) * FX`` from
    ``h`` (seed 0 by default).  Returns the hash's raw bits as int64, not
    an order key, so that it can seed the next call."""
    words = list(words)
    if not words:
        raise ValueError("need at least one word")
    if h is None:
        h = torch.zeros_like(words[0])
    for w in words:
        h = (_rotl5(h) ^ w) * FX_CONSTANT
    return h
