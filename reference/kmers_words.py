"""Exact canonical k-mer count tables for 32 <= K <= 62, in plain PyTorch
on the CPU, and the control that breaks the counting guarantee.

It imports nothing of either k-mer package.  A window's register holds its
K bases two bits each, the first base in the highest bits (A 0, C 1, G 2,
T and U 3, either case); its reverse complement is the register of the
complemented, reversed bases; the canonical register is the smaller of the
two.  A window is valid only when every byte in it is one of ACGTU in
either case, so windows over N or IUPAC codes are skipped.  A register of
2K bits (64 to 124) is held as the pair ``(hi, lo)``: its bits from 62 up
and its low 62 bits, two non-negative int64.  A table is ``(rows,
counts)``: ``rows`` an ``(n, 2)`` int64 tensor of distinct ``(hi, lo)``
pairs sorted by ``hi`` then ``lo``, ``counts`` how many valid windows hold
each.  That is the integer value split at bit 62, whatever a program keeps
inside.

The table is computed in blocks of windows on threads (torch's CPU
kernels release the interpreter's lock): each block's registers come from
those of power-of-two widths by doubling, and its rows are dealt into
buckets by their top bits.  Each bucket is then sorted (two ``torch.sort``
passes, ``lo`` then a stable one on ``hi``) and counted on its own, and
the buckets in order are the table.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import torch

K_MIN, K_MAX = 32, 62
#: bases in ``lo``: the low 62 bits of the register
LO_BASES = 31
#: windows a thread computes at a time
BLOCK = 1 << 21
#: the top bits of the register that pick a row's bucket
BUCKET_BITS = 8

_CODE = torch.zeros(256, dtype=torch.int64)
_GOOD = torch.zeros(256, dtype=torch.bool)
for _code, _letters in enumerate((b"Aa", b"Cc", b"Gg", b"TtUu")):
    for _b in _letters:
        _CODE[_b] = _code
        _GOOD[_b] = True


def _check_k(k: int) -> None:
    if not K_MIN <= k <= K_MAX:
        raise ValueError(f"the word reference takes {K_MIN} <= K <= {K_MAX} (got K={k})")


def _as_bytes(seq) -> torch.Tensor:
    """ASCII bytes (a uint8 array or tensor) as a 1-D uint8 tensor."""
    return torch.as_tensor(seq, dtype=torch.uint8).reshape(-1)


def _join(x: torch.Tensor, a: int, y: torch.Tensor, b: int, forward: bool) -> torch.Tensor:
    """Registers of ``a + b`` bases at every start, from those of the
    first ``a`` bases (``x``) and of the ``b`` bases after them (``y``):
    forward, the first bases are the high bits; reverse-complement, the
    low ones."""
    n = x.shape[0] - b
    if forward:
        return (x[:n] << (2 * b)) | y[a : a + n]
    return x[:n] | (y[a : a + n] << (2 * a))


def _registers(codes: torch.Tensor, widths, forward: bool) -> dict:
    """``{width: registers of width bases at every start}`` for each of
    ``widths`` (at most 31), forward or reverse-complement, built from
    powers of two by doubling."""
    powers = {1: codes if forward else 3 - codes}
    w = 1
    while 2 * w <= max(widths):
        powers[2 * w] = _join(powers[w], w, powers[w], w, forward)
        w *= 2
    out = {}
    for width in widths:
        reg, have = None, 0
        for p in sorted(powers, reverse=True):
            if have + p <= width:
                reg = powers[p] if reg is None else _join(reg, have, powers[p], p, forward)
                have += p
        out[width] = reg
    return out


def canonical_windows(seq, k: int):
    """``(hi, lo, valid)`` of every window of ``seq`` (ASCII bytes), in
    position order: the canonical register's two halves and whether the
    window is valid."""
    _check_k(k)
    seq = _as_bytes(seq)
    n = seq.shape[0] - k + 1
    if n <= 0:
        empty = torch.zeros(0, dtype=torch.int64)
        return empty, empty.clone(), torch.zeros(0, dtype=torch.bool)
    idx = seq.long()
    codes = _CODE[idx]
    hb = k - LO_BASES  # bases in hi
    fwd = _registers(codes, {hb, LO_BASES}, True)
    f_hi, f_lo = fwd[hb][:n], fwd[LO_BASES][hb : hb + n]
    del fwd
    rev = _registers(codes, {hb, LO_BASES}, False)
    # the reverse complement's low 62 bits are the window's first 31 bases
    r_hi, r_lo = rev[hb][LO_BASES : LO_BASES + n], rev[LO_BASES][:n]
    del rev
    take_rc = (r_hi < f_hi) | ((r_hi == f_hi) & (r_lo < f_lo))
    hi = torch.where(take_rc, r_hi, f_hi)
    lo = torch.where(take_rc, r_lo, f_lo)
    bad = torch.zeros(seq.shape[0] + 1, dtype=torch.int64)
    bad[1:] = torch.cumsum((~_GOOD[idx]).long(), 0)
    return hi, lo, (bad[k : k + n] - bad[:n]) == 0


def _bucket(hi: torch.Tensor, lo: torch.Tensor, k: int) -> torch.Tensor:
    """The top :data:`BUCKET_BITS` bits of each ``2k``-bit register."""
    hi_bits = 2 * (k - LO_BASES)
    if hi_bits >= BUCKET_BITS:
        return hi >> (hi_bits - BUCKET_BITS)
    rest = BUCKET_BITS - hi_bits
    return (hi << rest) | (lo >> (2 * LO_BASES - rest))


def _block_buckets(seq: torch.Tensor, k: int, start: int, stop: int) -> list:
    """The valid rows of windows ``[start, stop)``, dealt into buckets:
    ``[(hi, lo)]``, one pair a bucket."""
    hi, lo, valid = canonical_windows(seq[start : stop + k - 1], k)
    hi, lo = hi[valid], lo[valid]
    b = _bucket(hi, lo, k)
    order = torch.sort(b).indices
    sizes = torch.bincount(b, minlength=1 << BUCKET_BITS).tolist()
    return list(zip(torch.split(hi[order], sizes), torch.split(lo[order], sizes)))


def _lex_sort(hi: torch.Tensor, lo: torch.Tensor):
    """``(hi, lo)`` sorted by ``hi`` then ``lo``."""
    o1 = torch.sort(lo).indices
    h = hi[o1]
    o2 = torch.sort(h, stable=True).indices
    return h[o2], lo[o1[o2]]


def _runs(hi: torch.Tensor, lo: torch.Tensor):
    """Distinct rows of sorted ``(hi, lo)`` and how often each occurs."""
    n = hi.shape[0]
    if n == 0:
        return torch.zeros((0, 2), dtype=torch.int64), torch.zeros(0, dtype=torch.int64)
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = torch.nonzero(first).flatten()
    counts = torch.diff(torch.cat([starts, torch.tensor([n])]))
    return torch.stack([hi[starts], lo[starts]], 1), counts


def _pool(n_blocks: int):
    """Threads for an input of several blocks; none for one block, which
    torch's own threads serve (threads on threads only contend there)."""
    if n_blocks > 1:
        return ThreadPoolExecutor(os.cpu_count() or 1)
    return contextlib.nullcontext()


def count_table(seq, k: int):
    """The exact canonical count table of ``seq``: ``(rows, counts)``."""
    _check_k(k)
    seq = _as_bytes(seq)
    n = seq.shape[0] - k + 1
    starts = range(0, max(n, 0), BLOCK)
    with _pool(len(starts)) as pool:
        run = pool.map if pool is not None else map
        blocks = list(run(lambda s: _block_buckets(seq, k, s, min(s + BLOCK, n)), starts))

        def bucket(j: int):
            hi = torch.cat([b[j][0] for b in blocks]) if blocks else torch.zeros(0, dtype=torch.int64)
            lo = torch.cat([b[j][1] for b in blocks]) if blocks else torch.zeros(0, dtype=torch.int64)
            return _runs(*_lex_sort(hi, lo))

        tables = list(run(bucket, range(1 << BUCKET_BITS)))
    return torch.cat([r for r, _ in tables]), torch.cat([c for _, c in tables])


def window_rows(seq, pos: int, k: int) -> torch.Tensor:
    """The canonical rows ``(m, 2)`` of the valid windows of ``seq`` that
    cover position ``pos``."""
    seq = _as_bytes(seq)
    lo = max(pos - k + 1, 0)
    hi, low, valid = canonical_windows(seq[lo : pos + k], k)
    return torch.stack([hi[valid], low[valid]], 1)


def apply_delta(rows: torch.Tensor, counts: torch.Tensor, minus: torch.Tensor, plus: torch.Tensor):
    """The table ``(rows, counts)`` with one occurrence of each row of
    ``minus`` taken away and of each row of ``plus`` added; rows that
    reach zero are dropped.  ``minus`` must be a sub-multiset of the
    table."""
    delta: dict = {}
    for sign, part in ((-1, minus), (1, plus)):
        for h, l in part.tolist():
            delta[(h, l)] = delta.get((h, l), 0) + sign
    counts = counts.clone()
    if not delta:
        return rows.clone(), counts
    hi, lo = rows[:, 0].contiguous(), rows[:, 1].contiguous()
    keys = sorted(delta)
    q = torch.tensor([h for h, _ in keys], dtype=torch.int64)
    left = torch.searchsorted(hi, q).tolist()
    right = torch.searchsorted(hi, q, right=True).tolist()
    inserts = []
    for (h, l), a, b in zip(keys, left, right):
        j = a + int(torch.searchsorted(lo[a:b], torch.tensor([l])))
        w = delta[(h, l)]
        if j < b and int(lo[j]) == l:
            counts[j] += w
            if int(counts[j]) < 0:
                raise ValueError("apply_delta: a row taken away is not in the table")
        elif w < 0:
            raise ValueError("apply_delta: a row taken away is not in the table")
        elif w > 0:
            inserts.append((j, h, l, w))
    pieces_r, pieces_c, prev = [], [], 0
    for j, h, l, w in inserts:  # in (hi, lo) order, so in row order
        pieces_r += [rows[prev:j], torch.tensor([[h, l]], dtype=torch.int64)]
        pieces_c += [counts[prev:j], torch.tensor([w], dtype=torch.int64)]
        prev = j
    out_r = torch.cat(pieces_r + [rows[prev:]])
    out_c = torch.cat(pieces_c + [counts[prev:]])
    keep = out_c > 0
    return out_r[keep], out_c[keep]


def count_table_seam_double(seq, k: int, chunk: int):
    """The control of the counting guarantee "every valid window counted
    exactly once": chunks of ``chunk`` bytes that overlap by ``k`` bytes
    instead of ``k - 1``, so the window at each seam is counted twice."""
    seq = _as_bytes(seq)
    rows, counts = count_table(seq, k)
    step = chunk - k
    plus = [window_rows(seq[s : s + k], 0, k) for s in range(step, seq.shape[0] - k + 1, step)]
    plus = torch.cat(plus) if plus else torch.zeros((0, 2), dtype=torch.int64)
    return apply_delta(rows, counts, torch.zeros((0, 2), dtype=torch.int64), plus)
