"""Multi-word K-mer registers (K > 31): windows and counting, in plain torch.

Counterpart of ``kmers_tpu/ops/multiword.py``, in the word convention of
``convert.py``: a register is ``W = ceil(K / 31)`` int64 words of 62 bits,
word 0 the most significant, :data:`SENTINEL` in every word of an invalid
window.  Windows are in natural position order: column ``i`` is the
window of positions ``[i, i + K)``.  :func:`windows_mw` and
:func:`rc_windows_mw` build registers of any width (2, 4 or 8 bits a
symbol for the forward ones).

Counting sorts the columns lexicographically with the one library call
of the path, ``torch.sort`` (as ``lax.sort`` is in JAX): W stable passes,
least significant word first.  The sorted columns then get run ids, a
sorted int64 stream (:data:`SENTINEL` for the invalid run), so the
one-word machinery counts them: kernel K2 (``rle_unit``) for a chunk and
the weighted ``_run_length_encode`` of ``ops/count.py`` for a merge.
``ops/count.py::compact_counts`` (kernel K10) front-packs word tables as
well, every word plane with its column.  Word tables merge by K9's word
instance (``merge_tables_mw``: a merge path over word planes, counter
``mw_merge_rows``), so each row is sorted once, in its chunk (counter
``mw_sort_rows``), however many levels of the fold it climbs.
:func:`fx_hash_mw` is
the JAX package's FxHash of multi-limb registers, which routes word tables
in the sharded exchange (``parallel/multiword.py``).
"""

from __future__ import annotations

import torch

from ..convert import KEY_BITS_MAX, SENTINEL, SIGN_BIT, WORD_BASES, n_words
from ..utils.profiling import count
from .count import _run_length_encode, compact_counts
from .encode import classify_2bit
from .hashing import FX_CONSTANT, _rotl5
from .kernels.merge_kernel import lex_order, merge_tables_mw
from .kernels.rle_kernel import rle_unit
from .windows import or_field, window_valid_mask

__all__ = [
    "n_limbs",
    "windows_mw",
    "rc_windows_mw",
    "fx_hash_mw",
    "canonical_windows_mw",
    "canonical_windows_mw_bytes",
    "sort_count_mw",
    "merge_compact_tables_mw",
]

#: widest K of the array plane (the JAX ``CountConfig``'s limit)
K_MAX = 100


def _check_k(K: int) -> None:
    if not 1 <= K <= K_MAX:
        raise ValueError(f"multi-word windows support 1 <= K <= {K_MAX} (got K={K})")


def _forward(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Register of ``codes[p : p + width]`` at every start ``p``, first
    base in the highest bits."""
    n = codes.shape[0] - width + 1
    reg = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j in range(width):
        reg = (reg << 2) | codes[j : j + n]
    return reg


def _reverse_complement(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Reverse-complement register of ``codes[p : p + width]`` at every
    start ``p``: base ``j``'s complement lands in bits ``2j``."""
    n = codes.shape[0] - width + 1
    reg = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j in range(width):
        reg = reg | ((3 - codes[j : j + n]) << (2 * j))
    return reg


def _field_windows(codes: torch.Tensor, K: int, bps: int, lo_of) -> torch.Tensor:
    """``(n_words(K, bps), L - K + 1)`` words of the registers that hold
    ``codes[i + j]`` in bits ``[lo_of(j), lo_of(j) + bps)``."""
    n = max(codes.shape[0] - K + 1, 0)
    words = [torch.zeros(n, dtype=torch.int64, device=codes.device) for _ in range(n_words(K, bps))]
    c = codes.to(torch.int64)
    for j in range(K):
        or_field(words, c[j : j + n], lo_of(j), bps)
    return torch.stack(words)


def windows_mw(codes: torch.Tensor, K: int, bps: int = 2) -> torch.Tensor:
    """Forward registers of every K-window of a ``bps``-bit code stream, at
    any width: ``(n_words(K, bps), L - K + 1)`` int64 words, the first
    symbol in the highest bits (the JAX ``windows_mw``'s limbs, regrouped).
    Codes must be below ``2^bps``."""
    if K < 1:
        raise ValueError("K must be >= 1")
    return _field_windows(codes, K, bps, lambda j: bps * (K - 1 - j))


def rc_windows_mw(codes: torch.Tensor, K: int) -> torch.Tensor:
    """Reverse-complement registers of every K-window of a 2-bit code
    stream, at any width, aligned with :func:`windows_mw`: base ``j``'s
    complement lands in bits ``2j``."""
    if K < 1:
        raise ValueError("K must be >= 1")
    return _field_windows(codes.to(torch.int64) ^ 3, K, 2, lambda j: 2 * j)


def canonical_windows_mw(codes: torch.Tensor, K: int) -> torch.Tensor:
    """Canonical words of every K-window of an int64 2-bit code stream:
    ``(W, L - K + 1)`` int64, the lexicographic minimum of the forward
    and reverse-complement registers taken over the whole register."""
    _check_k(K)
    L = codes.shape[0]
    n = L - K + 1
    W = n_words(K)
    if n <= 0:
        return torch.zeros((W, 0), dtype=torch.int64, device=codes.device)
    # word w holds window bases [off, off + width): the first word the
    # K - 31 (W - 1) leading bases, every other word 31
    widths = [K - WORD_BASES * (W - 1)] + [WORD_BASES] * (W - 1)
    fwd = {w: _forward(codes, w) for w in set(widths)}
    rev = {w: _reverse_complement(codes, w) for w in set(widths)}
    fw, rc = [], []
    off = 0
    for width in widths:
        fw.append(fwd[width][off : off + n])
        # the same word of the reverse complement reads window bases
        # [K - off - width, K - off), reversed and complemented
        start = K - off - width
        rc.append(rev[width][start : start + n])
        off += width
    lt = torch.zeros(n, dtype=torch.bool, device=codes.device)
    eq = torch.ones(n, dtype=torch.bool, device=codes.device)
    for f, r in zip(fw, rc):
        lt = lt | (eq & (f < r))
        eq = eq & (f == r)
    return torch.where(lt | eq, torch.stack(fw), torch.stack(rc))


def canonical_windows_mw_bytes(bytes_u8: torch.Tensor, K: int):
    """Canonical words of every window of an ASCII byte tensor, in plain
    torch: the composition K3 fuses, for any ``1 <= K <= 100``.

    Returns ``(words, n_invalid, n_ambig)``: ``words`` ``(W, L)`` int64
    with :data:`SENTINEL` in every word of a window that touches a byte
    other than A/C/G/T/U (either case) and of the last K-1 positions, and
    0-d int64 counts of the invalid and the ambiguous bytes.
    """
    _check_k(K)
    codes, certain, ambig = classify_2bit(bytes_u8)
    L = bytes_u8.shape[0]
    words = torch.full(
        (n_words(K), L), SENTINEL, dtype=torch.int64, device=bytes_u8.device
    )
    win = canonical_windows_mw(codes, K)
    valid = window_valid_mask(certain, K)
    words[:, : win.shape[1]] = torch.where(valid, win, SENTINEL)
    return words, (~(certain | ambig)).sum(), ambig.sum()


def _lex_order(words: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the columns of ``(W, n)`` words
    lexicographically: W stable sorts, least significant word first.
    Counter ``mw_sort_rows``: the columns ordered (every chunk's sort, and
    the sharded path's sort of what the exchange delivers)."""
    count("mw_sort_rows", words.shape[1])
    return lex_order(words)


def _run_ids(swords: torch.Tensor) -> torch.Tensor:
    """Run ids of lexicographically sorted columns: ``0, 1, ...`` per run
    of equal columns, :data:`SENTINEL` for the run of invalid columns
    (which sorts last), so the ids are a sorted int64 stream."""
    n = swords.shape[1]
    first = torch.ones(n, dtype=torch.bool, device=swords.device)
    first[1:] = (swords[:, 1:] != swords[:, :-1]).any(0)
    ids = torch.cumsum(first, 0) - 1
    # a real word is never SENTINEL, so word 0 marks the invalid run
    return torch.where(swords[0] == SENTINEL, SENTINEL, ids)


def sort_count_mw(words: torch.Tensor, valid: torch.Tensor | None = None):
    """Count the distinct columns of ``(W, n)`` words.

    Returns ``(uniq, counts, n_unique)``: a sentinel-interspersed table of
    the input's length (each run's last column keeps its words and the
    run's length, every other column is :data:`SENTINEL`/0) and the number
    of distinct non-sentinel registers.  ``valid`` (optional bool) routes
    masked columns to the sentinel.
    """
    if valid is not None:
        words = torch.where(valid, words, SENTINEL)
    swords = words[:, _lex_order(words)]
    _, counts, n_unique = rle_unit(_run_ids(swords))
    return torch.where(counts > 0, swords, SENTINEL), counts, n_unique


def merge_compact_tables_mw(words_a, counts_a, words_b, counts_b):
    """Merge two *sorted* word count tables (padding columns only at the
    tail): K9's word instance, then run ids, the weighted RLE, and K10's
    front-packing.  Returns ``(words, counts, n_unique)``; the first
    ``n_unique`` columns are the merged table, in order."""
    swords, counts = merge_tables_mw(
        words_a, counts_a.to(torch.int64), words_b, counts_b.to(torch.int64)
    )
    _, totals, n_unique = _run_length_encode(_run_ids(swords), counts)
    uniq = torch.where(totals > 0, swords, SENTINEL)
    return (*compact_counts(uniq, totals), n_unique)


def n_limbs(K: int, bps: int = 2) -> int:
    """The JAX package's 32-bit limbs of a register of K ``bps``-bit
    symbols: ``ceil(bps K / 32)``."""
    return -(-(K * bps) // 32)


def fx_hash_mw(words: torch.Tensor, K: int, bps: int = 2) -> torch.Tensor:
    """Order keys (the sign bit flipped, as :func:`~.hashing.fx_hash_u64`)
    of the seed-0 FxHash of ``(W, n)`` registers of K ``bps``-bit symbols.

    Bit for bit the JAX ``fx_hash_mw`` over its ``M = n_limbs(K, bps)``
    limbs: the register is cut big-endian into 64-bit words, the top word
    holding what is left (its limb pairs, with a leading zero limb when M
    is odd), and ``h = ((h rotl 5) ^ word) * FX`` folds them from the top.
    The port's 62-bit words are regrouped into those 64-bit words first
    (as ``convert._regroup``), with shifts that wrap in int64.  Sentinel
    columns hash to arbitrary keys.
    """
    W = words.shape[0]
    n64 = -(-n_limbs(K, bps) // 2)
    h = torch.zeros(words.shape[1:], dtype=torch.int64, device=words.device)
    for o in range(n64):
        lo = 64 * (n64 - 1 - o)  # lowest register bit of this 64-bit word
        piece = torch.zeros_like(h)
        for p in range(W):
            base = KEY_BITS_MAX * (W - 1 - p)
            if base + KEY_BITS_MAX <= lo or base >= lo + 64:
                continue  # no bit of word p falls in this piece
            x = words[p]
            piece |= (x << (base - lo)) if base >= lo else (x >> (lo - base))
        h = (_rotl5(h) ^ piece) * FX_CONSTANT
    return h ^ SIGN_BIT
