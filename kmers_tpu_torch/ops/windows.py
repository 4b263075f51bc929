"""Window registers over a code stream, in plain torch.

Counterparts of ``kmers_tpu/ops/windows.py`` (``windows_from_codes``,
``rc_windows_from_codes``, ``canonical_windows_from_codes``,
``rc_windows_4bit_from_codes``, ``canonical_windows_4bit_from_codes``,
``window_valid_mask``), in natural
position order: entry ``i`` is the window of positions ``[i, i + K)``,
first symbol in the highest bits (the scalar ``Kmer`` layout).  Registers
are int64; one of 64 bits (K = 32 at 2 bits, K = 16 at 4) is a raw bit
pattern, so canonical selection compares as unsigned.  Codes must be
below ``2^bps``: as in the JAX package, they are not masked.  These are
the building blocks of the plain versions of kernels K1
(``ops/kernels/window_kernel.py``) and K6 (``ops/kernels/general_kernel.py``).
"""

from __future__ import annotations

import torch

from ..convert import KEY_BITS_MAX, SIGN_BIT

__all__ = [
    "windows_from_codes",
    "rc_windows_from_codes",
    "canonical_windows_from_codes",
    "rc_windows_4bit_from_codes",
    "canonical_windows_4bit_from_codes",
    "window_valid_mask",
]


def _check_k(K: int, bps: int) -> None:
    """The JAX package's limits and exception types: one register word."""
    if K * bps > 64:
        raise NotImplementedError(f"windows support K*bps <= 64 (got K={K}, bps={bps})")
    if K < 1:
        raise ValueError("K must be >= 1")


def _shifted_or(codes: torch.Tensor, K: int, shift_of) -> torch.Tensor:
    """``OR_j codes[i + j] << shift_of(j)`` for every window ``i``."""
    n = codes.shape[0] - K + 1
    out = torch.zeros(max(n, 0), dtype=torch.int64, device=codes.device)
    if n <= 0:
        return out
    c = codes.to(torch.int64)
    for j in range(K):
        out |= c[j : j + n] << shift_of(j)
    return out


def windows_from_codes(codes: torch.Tensor, K: int, bps: int = 2) -> torch.Tensor:
    """Forward registers of every K-window of a ``bps``-bit code stream
    (``K * bps <= 64``): ``L - K + 1`` int64 values."""
    _check_k(K, bps)
    return _shifted_or(codes, K, lambda j: bps * (K - 1 - j))


def rc_windows_from_codes(codes: torch.Tensor, K: int) -> torch.Tensor:
    """Reverse-complement registers of every K-window of a 2-bit code
    stream (K <= 32), aligned with :func:`windows_from_codes`: base ``j``'s
    complement is base ``K - 1 - j`` of the reverse complement."""
    _check_k(K, 2)
    return _shifted_or(codes.to(torch.int64) ^ 3, K, lambda j: 2 * j)


def _unsigned_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of int64 bit patterns read as unsigned."""
    return torch.where((a ^ SIGN_BIT) <= (b ^ SIGN_BIT), a, b)


def canonical_windows_from_codes(codes: torch.Tensor, K: int) -> torch.Tensor:
    """``min(forward, reverse complement)`` register of every K-window of a
    2-bit code stream (K <= 32; unsigned minimum): ``L - K + 1`` int64
    values."""
    return _unsigned_minimum(windows_from_codes(codes, K), rc_windows_from_codes(codes, K))


def rc_windows_4bit_from_codes(codes: torch.Tensor, K: int) -> torch.Tensor:
    """Reverse-complement registers of every K-window of a 4-bit nucleotide
    code stream (K <= 16), aligned with :func:`windows_from_codes`: the
    4-bit complement of a code is its nibble bit reversal (gap and N are
    their own complements)."""
    _check_k(K, 4)
    c = codes.to(torch.int64)
    comp = ((c & 1) << 3) | ((c & 2) << 1) | ((c & 4) >> 1) | ((c & 8) >> 3)
    return _shifted_or(comp, K, lambda j: 4 * j)


def canonical_windows_4bit_from_codes(codes: torch.Tensor, K: int) -> torch.Tensor:
    """``min(forward, reverse complement)`` over a 4-bit nucleotide code
    stream (K <= 16; unsigned minimum)."""
    rc = rc_windows_4bit_from_codes(codes, K)
    return _unsigned_minimum(windows_from_codes(codes, K, bps=4), rc)


def or_field(words: list, vals: torch.Tensor, lo: int, width: int) -> None:
    """OR ``width``-bit values into bits ``[lo, lo + width)`` of the
    registers held in ``words`` (``convert.py``'s words: word 0 most
    significant, 62 bits each): one word, or two where the field straddles
    a word boundary."""
    W = len(words)
    for q in range(W):  # q: word counted from the least significant
        base = KEY_BITS_MAX * q
        if lo + width <= base or lo >= base + KEY_BITS_MAX:
            continue
        if lo >= base:
            s = lo - base
            # keep the bits that land in this word, so the shift cannot overflow
            words[W - 1 - q] |= (vals & ((1 << (KEY_BITS_MAX - s)) - 1)) << s
        else:
            words[W - 1 - q] |= vals >> (base - lo)


def window_valid_mask(good: torch.Tensor, K: int) -> torch.Tensor:
    """Per-window "all K symbols good" mask of a per-symbol bool tensor:
    ``L - K + 1`` entries."""
    L = good.shape[0]
    n = L - K + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.bool, device=good.device)
    bad = torch.zeros(L + 1, dtype=torch.int64, device=good.device)
    bad[1:] = torch.cumsum((~good).to(torch.int64), 0)
    return (bad[K : L + 1] - bad[0:n]) == 0
