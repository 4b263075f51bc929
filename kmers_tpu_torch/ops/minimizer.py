"""Windowed minimizer selection and closed syncmers over k-mer streams, in
plain torch.

Counterpart of ``kmers_tpu/ops/minimizer.py``: for every window of ``W``
consecutive k-mers, the k-mer with the smallest FxHash, leftmost on ties.
The same doubling ("sparse table") sliding minimum: O(log W) rounds of
elementwise minimum over shifted tensors of (hash key, position) pairs, the
k-mer carried along with the winner.  Hashes are int64 order keys
(``convert.py``), so the signed comparison is the JAX package's unsigned
one; positions are int64.

Where each route runs: ``minimizer_select`` on CUDA at K <= 31 and
W <= 256 takes kernel K12 (``ops/kernels/minimizer_kernel.py``) in place of
:func:`minimizers` and :func:`minimizers_masked`; these run its plain route
(the CPU, K = 32, wider windows) and the sharded driver
(``parallel/minimizers.py``) on every device.  Syncmers
(:func:`closed_syncmer_mask`) are plain torch everywhere.
"""

from __future__ import annotations

import torch

from ..convert import SENTINEL
from ..utils.profiling import count
from .hashing import fx_hash_u64

__all__ = [
    "sliding_min_u64",
    "minimizers",
    "minimizers_masked",
    "closed_syncmer_mask",
]


def _sliding_min_with(keys: torch.Tensor, extras: tuple, W: int):
    """Doubling sliding minimum over ``(keys, position)`` with ``extras``
    (same-length tensors) carried along with the winner.  Returns
    ``(min_keys, argmin_pos, *min_extras)`` for the ``n - W + 1`` windows."""
    if W < 1:
        raise ValueError("W must be >= 1")
    n = keys.shape[0]
    m = n - W + 1
    if m <= 0:
        return (keys[:0], torch.zeros(0, dtype=torch.int64, device=keys.device)) + tuple(
            x[:0] for x in extras
        )
    pos = torch.arange(n, dtype=torch.int64, device=keys.device)
    cur = (keys, pos) + tuple(extras)

    def comb(a, b):
        count("minimum_rows", a[0].shape[0])
        a_lt = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))
        return tuple(torch.where(a_lt, x, y) for x, y in zip(a, b))

    # doubling: after a round of span s, cur[i] is the minimum over [i, i + 2s)
    span = 1
    while span * 2 <= W:
        cur = comb(tuple(x[: x.shape[0] - span] for x in cur), tuple(x[span:] for x in cur))
        span *= 2
    # two overlapping spans of length `span` cover W
    off = W - span
    return comb(tuple(x[:m] for x in cur), tuple(x[off : off + m] for x in cur))


def sliding_min_u64(keys: torch.Tensor, W: int):
    """For each of the ``n - W + 1`` windows of ``W`` consecutive int64
    order keys, ``(min_key, argmin_pos)``, leftmost on ties."""
    return _sliding_min_with(keys, (), W)


def closed_syncmer_mask(smer_keys: torch.Tensor, K: int, s: int) -> torch.Tensor:
    """Closed-syncmer mask over a k-mer stream, given the hash keys of all
    s-mers: k-mer ``i`` (s-mers ``[i, i + K - s]``) is a closed syncmer iff
    the minimal s-mer of its span sits at its first or last offset,
    compared by value.  ``n_smers - (K - s)`` entries."""
    span = K - s + 1
    mk, _ = sliding_min_u64(smer_keys, span)
    n = mk.shape[0]
    return (smer_keys[:n] == mk) | (smer_keys[span - 1 :] == mk)


def minimizers(kmers: torch.Tensor, W: int):
    """(W, K)-minimizers of an int64 k-mer stream: per window of W
    consecutive k-mers, ``(kmer, position)`` of the smallest FxHash.
    Consecutive windows often share theirs; callers drop repeats."""
    _, pos, kmer = _sliding_min_with(fx_hash_u64(kmers), (kmers,), W)
    return kmer, pos


def minimizers_masked(kmers: torch.Tensor, valid: torch.Tensor, W: int):
    """Skip-ambiguous (W, K)-minimizers: k-mers with ``valid == False`` are
    no candidates (their key becomes :data:`SENTINEL`, the key of the
    all-ones hash, as in the JAX package); a window without a candidate
    gives position -1."""
    keys = torch.where(valid, fx_hash_u64(kmers), SENTINEL)
    mk, pos, kmer = _sliding_min_with(keys, (kmers,), W)
    return kmer, torch.where(mk == SENTINEL, -1, pos)
