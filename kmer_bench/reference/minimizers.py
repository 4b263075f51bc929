"""The plain reference of the minimizer cells: (w, k)-minimizers of a
nucleotide sequence in plain PyTorch on the CPU, and the control that
breaks the sampling's tie rule.  A frozen copy of the repository's
``reference/minimizers.py`` (a copy, not an import), so that the
benchmark's yardstick does not move with the repository.

It imports nothing of either k-mer package, and it does not follow the
port's algorithm (K6's registers, then a doubling sliding minimum): each
k-mer's value comes from shifts over 2-bit codes, and each window's pick
from one ``argmin`` over an ``unfold`` of its w keys.

- A base is certain when it is A, C, G, T or U, in either case
  (:data:`_CODE`); every other byte is not.  A k-mer is valid only when all
  k of its bases are certain.
- A k-mer's forward value holds its bases 2 bits each (A 0, C 1, G 2,
  T/U 3), the first base highest; its reverse-complement value is that of
  its reverse complement.  Its canonical value is the smaller of the two,
  compared unsigned (a k = 32 value fills 64 bits).
- Its key is its FxHash, ``(v * 0x517CC1B727220A95) mod 2^64``, compared
  unsigned (as an int64 with the sign bit flipped).
- Window ``i`` covers k-mers ``i .. i + w - 1``.  It picks the valid k-mer
  of the smallest key, the leftmost of equal keys (``argmin``'s first
  index); a window without a valid k-mer picks nothing.
- The sampling is the windows' picks as ``(value, position)`` rows in
  window order, consecutive equal positions dropped.

The picks are computed in blocks of windows on threads (torch's CPU
kernels release the interpreter's lock); a block reads its windows' bases
and their right halo of ``w + k - 2``, so the block size does not change
the answer.

Departures from minimap2 (Li 2018, ``sketch.c::mm_sketch``, the sampling
behind ``minimap2 -x map-ont -d``):

- FxHash in place of minimap2's invertible ``hash64`` (masked to 2k bits);
- the leftmost of equal minima kept, where ``mm_sketch`` keeps repeated
  minima its own way (it may emit each of a window's equal minima);
- ``(value, position)`` rows in place of minimap2's ``(hash, position,
  strand, span)`` records.

At odd k no k-mer is its own reverse complement, so minimap2's skip of
symmetric k-mers never applies.  A valid k-mer whose key equals an invalid
one's (:data:`_NONE`, a hash of all ones) would count as none; that value
is ``0xDFBFFFC287F68F43``, above every register of k <= 31.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: FxHash's multiplier (below 2^63, so a positive int64)
FX = 0x517CC1B727220A95
#: the sign bit: flipped, an int64 compares as its unsigned bit pattern
SIGN = -(1 << 63)
#: the key of an invalid k-mer: above every other key
_NONE = (1 << 63) - 1
#: windows a block computes
BLOCK = 1 << 22

#: byte -> 2-bit code of a certain base, -1 for any other byte
_CODE = torch.full((256,), -1, dtype=torch.int64)
for _ch, _c in zip(b"ACGTU", (0, 1, 2, 3, 3)):
    _CODE[_ch] = _c
    _CODE[_ch | 0x20] = _c


def _as_bytes(seq) -> torch.Tensor:
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), np.uint8)
    return torch.from_numpy(np.ascontiguousarray(seq, dtype=np.uint8))


def _unsigned_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ SIGN) < (b ^ SIGN)


def kmer_values(seq, k: int, canonical: bool = True):
    """``(values, valid)`` of the ``len(seq) - k + 1`` k-mers: int64 bit
    patterns (canonical or forward) and whether all k bases are certain."""
    code = _CODE[_as_bytes(seq).long()]
    certain = code >= 0
    code = code.clamp(min=0)
    n = code.shape[0] - k + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool)
    fwd = torch.zeros(n, dtype=torch.int64)
    rc = torch.zeros(n, dtype=torch.int64)
    for j in range(k):
        c = code[j : j + n]
        fwd = (fwd << 2) | c
        rc |= (3 - c) << (2 * j)
    values = torch.where(_unsigned_lt(rc, fwd), rc, fwd) if canonical else fwd
    bad = torch.zeros(code.shape[0] + 1, dtype=torch.int64)
    bad[1:] = torch.cumsum((~certain).long(), 0)
    return values, (bad[k : k + n] - bad[:n]) == 0


def _block(seq: torch.Tensor, k: int, w: int, canonical: bool, start: int, stop: int, rightmost: bool):
    """The picks of windows ``[start, stop)``: ``(values, positions)``,
    position -1 where a window picks nothing."""
    values, valid = kmer_values(seq[start : stop + w + k - 2], k, canonical)
    keys = torch.where(valid, (values * FX) ^ SIGN, _NONE)
    win = keys.unfold(0, w, 1)
    if rightmost:
        at = w - 1 - torch.argmin(win.flip(1), 1)
    else:
        at = torch.argmin(win, 1)
    idx = torch.arange(win.shape[0]) + at
    some = valid.long().unfold(0, w, 1).amax(1) > 0
    pos = torch.where(some, idx + start, -1)
    return torch.where(some, values[idx], 0), pos


def _pool(n_blocks: int):
    """Threads for an input of several blocks; none for one block."""
    if n_blocks > 1:
        return ThreadPoolExecutor(os.cpu_count() or 1)
    return contextlib.nullcontext()


def window_picks(seq, k: int, w: int, canonical: bool = True, block: int = BLOCK, rightmost: bool = False):
    """Every window's pick, in window order: ``(values np.uint64,
    positions np.int64)``, ``len(seq) - k - w + 2`` of each, position -1
    (value 0) where a window has no valid k-mer.  ``rightmost`` breaks the
    tie rule: the rightmost of equal minima (the control)."""
    if not (1 <= k <= 32 and w >= 1):
        raise ValueError("need 1 <= k <= 32 and w >= 1")
    t = _as_bytes(seq)
    n = t.shape[0] - k - w + 2
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    starts = range(0, n, block)
    with _pool(len(starts)) as pool:
        run = (pool.map if pool is not None else map)(
            lambda a: _block(t, k, w, canonical, a, min(a + block, n), rightmost), starts)
        parts = list(run)
    values = torch.cat([v for v, _ in parts]).numpy().view(np.uint64)
    return values, torch.cat([p for _, p in parts]).numpy()


def dedup(values: np.ndarray, positions: np.ndarray):
    """Window picks as the sampling: windows that picked nothing and
    consecutive equal positions dropped."""
    keep = positions >= 0
    keep[1:] &= positions[1:] != positions[:-1]
    return values[keep], positions[keep]


def minimizers(seq, k: int, w: int, canonical: bool = True, block: int = BLOCK, rightmost: bool = False):
    """The (w, k)-minimizer sampling of ``seq``: ``(values np.uint64,
    positions np.int64)``, positions ascending."""
    return dedup(*window_picks(seq, k, w, canonical, block, rightmost))
