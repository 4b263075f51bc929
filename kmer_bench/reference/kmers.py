"""The plain reference: canonical k-mer count tables and MinHash sketches
with numpy alone (K <= 31), and the controls that break one guarantee each.

It imports nothing of the program.  Its arithmetic is the one the port's
smoke script checks against (a frozen copy, not an import): a window's
forward register holds its bases two bits each, the first base in the
highest bits (A 0, C 1, G 2, T and U 3, case ignored); its reverse
complement is the register of the complemented, reversed bases; the
canonical register is the smaller of the two.  A window is valid when every
byte in it is one of ACGTU in either case, so windows over N, IUPAC codes
or record separators are skipped.  A sketch is the ``s`` smallest distinct
FxHashes (``register * 0x517CC1B727220A95 mod 2^64``) of the valid
canonical registers.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: FxHash's multiplier: the hash of a one-word register is reg * FX mod 2^64
FX = np.uint64(0x517CC1B727220A95)
#: the bytes a valid window may hold
_GOOD = np.zeros(256, bool)
_GOOD[list(b"ACGTUacgtu")] = True


#: windows a thread computes at a time
BLOCK = 1 << 19


_M2 = (np.uint64(0x3333333333333333), np.uint64(0x0F0F0F0F0F0F0F0F), np.uint64(0x00FF00FF00FF00FF),
       np.uint64(0x0000FFFF0000FFFF))


def _registers(seq: np.ndarray, k: int, out: np.ndarray) -> None:
    """The canonical register of every window of ``seq`` into ``out``.

    Forward registers by doubling: the register of ``2w`` bases at ``p``
    is that of ``w`` bases at ``p`` shifted up past that of ``w`` bases at
    ``p + w``; powers of two then add up to ``k``.  The reverse complement
    is the forward register with every code complemented (``c ^ 3``) and
    the order of its ``k`` 2-bit codes reversed."""
    codes = (((seq >> 1) ^ (seq >> 2)) & 3).astype(np.uint64)
    size = codes.size
    regs, w = {1: codes}, 1
    while 2 * w <= k:
        r = regs[w]
        regs[2 * w] = (r[: size - 2 * w + 1] << np.uint64(2 * w)) | r[w:]
        w *= 2
    fw, width = None, 0
    for p in sorted(regs, reverse=True):
        if width + p <= k:
            r = regs[p]
            if fw is None:
                fw = r.copy()
            else:
                fw = (fw[: size - width - p + 1] << np.uint64(2 * p)) | r[width:]
            width += p
    del regs
    x = fw ^ np.uint64((1 << 2 * k) - 1)
    for shift, m in zip((2, 4, 8, 16), _M2):
        s_ = np.uint64(shift)
        x = ((x >> s_) & m) | ((x & m) << s_)
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    x >>= np.uint64(64 - 2 * k)
    np.minimum(fw, x, out=out)


def canonical_windows(seq: np.ndarray, k: int):
    """``(canonical, valid)`` for every window of ``seq`` (uint8 ASCII):
    the canonical uint64 register and whether the window is valid.  Blocks
    of :data:`BLOCK` windows run on threads (numpy's loops release the
    interpreter's lock)."""
    n = seq.size - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    can = np.empty(n, np.uint64)
    starts = range(0, n, BLOCK)

    def block(lo: int) -> None:
        hi = min(lo + BLOCK, n)
        _registers(seq[lo : hi + k - 1], k, can[lo:hi])

    if len(starts) == 1:
        block(0)
    else:
        with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
            list(pool.map(block, starts))
    good = _GOOD[seq]
    bad = np.concatenate([[0], np.cumsum(~good, dtype=np.int64)])
    return can, (bad[k:] - bad[:n]) == 0


def _runs(sorted_keys: np.ndarray):
    """Distinct values of a sorted array and how often each occurs."""
    m = sorted_keys.size
    if m == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    first = np.ones(m, bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    starts = np.flatnonzero(first)
    return sorted_keys[starts], np.diff(np.append(starts, m)).astype(np.int64)


def count_table(seq: np.ndarray, k: int):
    """Sorted distinct canonical k-mers of ``seq`` (uint64) and their
    counts (int64): each valid window counted once."""
    can, valid = canonical_windows(seq, k)
    keys = can[valid]
    del can, valid
    keys.sort()
    return _runs(keys)


def window_kmers(seq: np.ndarray, pos: int, k: int) -> np.ndarray:
    """The valid canonical k-mers of the windows of ``seq`` that cover
    position ``pos``."""
    lo = max(pos - k + 1, 0)
    can, valid = canonical_windows(seq[lo : pos + k], k)
    return can[valid]


def apply_delta(kmers: np.ndarray, counts: np.ndarray, minus: np.ndarray, plus: np.ndarray):
    """The table ``(kmers, counts)`` with one occurrence of each k-mer in
    ``minus`` taken away and of each in ``plus`` added; rows that reach
    zero are dropped.  ``minus`` must be a sub-multiset of the table."""
    keys = np.concatenate([minus, plus]).astype(np.uint64)
    if keys.size == 0:
        return kmers.copy(), counts.copy()
    weight = np.concatenate([np.full(minus.size, -1, np.int64), np.ones(plus.size, np.int64)])
    order = np.argsort(keys, kind="stable")
    keys, starts = np.unique(keys[order], return_index=True)
    sums = np.add.reduceat(weight[order], starts)
    idx = np.searchsorted(kmers, keys)
    hit = idx < kmers.size
    hit[hit] = kmers[idx[hit]] == keys[hit]
    out_c = counts.copy()
    out_c[idx[hit]] += sums[hit]
    if (out_c[idx[hit]] < 0).any() or (sums[~hit] < 0).any():
        raise ValueError("apply_delta: a k-mer taken away is not in the table")
    new = ~hit & (sums > 0)
    out_k = np.insert(kmers, idx[new], keys[new])
    out_c = np.insert(out_c, idx[new], sums[new])
    keep = out_c > 0
    return out_k[keep], out_c[keep]


def count_table_seam_double(seq: np.ndarray, k: int, chunk: int):
    """The control of the counting guarantee "every valid window counted
    exactly once": chunks of ``chunk`` bytes that overlap by ``k`` bytes
    instead of ``k - 1``, so the window at each seam is counted twice."""
    kmers, counts = count_table(seq, k)
    step = chunk - k
    seams = np.arange(step, seq.size - k + 1, step)
    extra = [canonical_windows(seq[s : s + k], k) for s in seams]
    plus = np.array([c[0] for c, v in extra if v[0]], np.uint64)
    return apply_delta(kmers, counts, np.zeros(0, np.uint64), plus)


def hash_table(seq: np.ndarray, k: int, head: int | None = None):
    """Sorted distinct FxHashes of the valid canonical k-mers of ``seq``
    and how often each occurs; the ``head`` smallest only, when given."""
    can, valid = canonical_windows(seq, k)
    h = can[valid]
    del can, valid
    h *= FX
    h.sort()
    hashes, counts = _runs(h)
    return (hashes, counts) if head is None else (hashes[:head], counts[:head])


def sketch(seq: np.ndarray, k: int, s: int) -> np.ndarray:
    """The ``s`` smallest distinct FxHashes of the canonical k-mers."""
    return hash_table(seq, k, head=s)[0]


def sketch_after(head_h: np.ndarray, head_c: np.ndarray, minus: np.ndarray, plus: np.ndarray,
                 s: int) -> np.ndarray:
    """The sketch of a sequence whose hash table's smallest rows are
    ``(head_h, head_c)`` after one occurrence of each k-mer of ``minus`` is
    taken away and one of each of ``plus`` added.  Exact when the head holds
    more than ``s + minus.size`` rows or the whole table: a k-mer taken away
    that lies past the head is larger than every head row."""
    mh, ph = minus * FX, plus * FX
    inside = mh <= head_h[-1] if head_h.size else np.zeros(mh.size, bool)
    return apply_delta(head_h, head_c, mh[inside], ph)[0][:s]


def sketch_hash32(seq: np.ndarray, k: int, s: int) -> np.ndarray:
    """The control of the sketch guarantee "the s smallest distinct 64-bit
    FxHashes": each hash cut to its top 32 bits, the width Mash itself
    hashes short k-mers to."""
    can, valid = canonical_windows(seq, k)
    h = (can[valid] * FX) >> np.uint64(32) << np.uint64(32)
    return np.unique(h)[:s]
