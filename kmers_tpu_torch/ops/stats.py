"""Batched statistics of k-mer registers, in plain torch.

Counterpart of ``kmers_tpu/ops/stats.py`` over the port's int64 registers
(``convert.py``; a 64-bit register, K = 32 at 2 bits, is a raw bit
pattern).  ``gc_count_u64`` is the reference's 2-bit GC popcount:
``popcount((w ^ (w >> 1)) & 0x5555...)`` per register, since C=01 and G=10
differ in their two bits and A=00 and T=11 do not.  The popcount is the
reference's SWAR ladder on 32-bit halves.
"""

from __future__ import annotations

import torch

__all__ = ["popcount32", "gc_count_u64", "gc_fraction_windows"]

_LOW32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each int64 value, as int64."""
    x = x & _LOW32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _LOW32) >> 24


def gc_count_u64(regs: torch.Tensor) -> torch.Tensor:
    """GC symbols of each 2-bit register (int64, any 64-bit pattern)."""
    # the arithmetic shift drags the sign into bit 63, which the mask drops
    m = (regs ^ (regs >> 1)) & 0x5555555555555555
    return popcount32(m) + popcount32(m >> 32)


def gc_fraction_windows(regs: torch.Tensor, K: int | None = None) -> torch.Tensor:
    """GC fraction of each register as float32: the GC count over ``K``,
    or the count itself when no ``K`` is given."""
    c = gc_count_u64(regs).to(torch.float32)
    if K:
        c = c / K
    return c
