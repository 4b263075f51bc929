"""Sort-based unique counting of int64 key streams.

Counterpart of ``kmers_tpu/ops/count.py``.  Counting is ``torch.sort``
(the one library algorithm on the path, as ``lax.sort`` is in JAX) followed
by run-length encoding: unit weights through kernel K2 for a chunk, count
weights through the plain weighted RLE for table merges.

A count table is sentinel-interspersed as in the JAX package: each run's
last slot keeps its key and total, every other slot holds
:data:`SENTINEL` and count 0, and real rows stay sorted.  Keys are int64
registers of at most 62 bits (``convert.py``), counts int64.
"""

from __future__ import annotations

import torch

from ..convert import KEY_BITS_MAX, SENTINEL
from .kernels.rle_kernel import rle_unit

__all__ = [
    "SENTINEL",
    "sort_count",
    "merge_sorted_counts",
    "compact_counts",
    "merge_compact_tables",
]


def _run_length_encode(keys: torch.Tensor, weights: torch.Tensor | None = None):
    """``(uniq, counts, n_unique)`` of a sorted key stream; ``weights``
    (default 1) are summed per run.  A run's total is its inclusive weight
    cumsum minus the exclusive cumsum at the run's first index, which a
    binary search of the sorted keys finds (the JAX package carries it
    with ``lax.cummax``, whose torch counterpart was measured at 63 % of
    the slice's device time on an H100 — PERF.md)."""
    n = keys.shape[0]
    dev = keys.device
    is_last = torch.ones(n, dtype=torch.bool, device=dev)
    is_last[:-1] = keys[1:] != keys[:-1]
    if weights is None:
        w = torch.ones(n, dtype=torch.int64, device=dev)
    else:
        w = weights.to(torch.int64)
    wcum = torch.cumsum(w, 0)
    start = torch.searchsorted(keys, keys)
    emit = is_last & (keys != SENTINEL)
    uniq = torch.where(emit, keys, SENTINEL)
    counts = torch.where(emit, wcum - (wcum - w)[start], 0)
    return uniq, counts, emit.sum()


def sort_count(keys: torch.Tensor, valid: torch.Tensor | None = None,
               key_bits: int | None = None):
    """Count the distinct keys of an int64 stream.

    Returns ``(uniq, counts, n_unique)``: a sentinel-interspersed table of
    the input's length and the number of distinct non-sentinel keys.
    ``valid`` (optional bool) routes masked keys to the sentinel.
    ``key_bits``, the register width ``2 * K`` of the caller's keys, is
    checked: a wider key could reach the sentinel and be dropped.
    """
    if key_bits is not None and key_bits > KEY_BITS_MAX:
        raise ValueError(
            f"sort_count holds {key_bits}-bit keys in an int64 register whose "
            "INT64_MAX value is the invalid-window sentinel; keys wider than "
            f"{KEY_BITS_MAX} bits could collide with it"
        )
    if valid is not None:
        keys = torch.where(valid, keys, SENTINEL)
    # unstable: equal keys are bit-identical, so the order within a run is moot
    skeys = torch.sort(keys, stable=False).values
    return rle_unit(skeys)


def compact_counts(keys: torch.Tensor, counts: torch.Tensor):
    """Front-pack the real rows (count > 0) of a sentinel-interspersed
    table, in order; the tail becomes sentinel/0.  ``keys`` is ``(n,)``
    or, for multi-word registers, ``(W, n)`` (the counterpart of both
    ``compact_counts`` and ``compact_counts_mw``).  Same length in and
    out; rows are scattered to their rank, and every hole to a spare slot
    that is dropped."""
    n = counts.shape[0]
    real = counts > 0
    dest = torch.where(real, torch.cumsum(real, 0) - 1, n)
    out_k = torch.full(
        (*keys.shape[:-1], n + 1), SENTINEL, dtype=torch.int64, device=keys.device
    )
    out_c = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    out_k.scatter_(-1, dest.expand_as(keys), keys)
    out_c.scatter_(0, dest, torch.where(real, counts.to(torch.int64), 0))
    return out_k[..., :n], out_c[:n]


def merge_sorted_counts(keys_a, counts_a, keys_b, counts_b):
    """Merge two count tables: concatenate, sort, and sum equal keys.
    Returns ``(uniq, counts, n_unique)``, sentinel-interspersed."""
    keys = torch.cat([keys_a, keys_b])
    counts = torch.cat([counts_a, counts_b]).to(torch.int64)
    skeys, order = torch.sort(keys, stable=False)
    return _run_length_encode(skeys, counts[order])


def merge_compact_tables(keys_a, counts_a, keys_b, counts_b):
    """:func:`merge_sorted_counts`, front-packed by :func:`compact_counts`.
    Returns ``(keys, counts, n_unique)``; the first ``n_unique`` rows are
    the merged table."""
    uniq, counts, n_unique = merge_sorted_counts(keys_a, counts_a, keys_b, counts_b)
    keys, counts = compact_counts(uniq, counts)
    return keys, counts, n_unique
