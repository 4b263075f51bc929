"""Sort-based unique counting of int64 key streams, and the device table
fold.

Counterpart of ``kmers_tpu/ops/count.py``.  Counting is ``torch.sort``
(the one library algorithm on the path, as ``lax.sort`` is in JAX) followed
by run-length encoding with unit weights (kernel K2).  A chunk's table is
sentinel-interspersed as in the JAX package: each run's last slot keeps its
key and total, every other slot holds :data:`SENTINEL` and count 0, and real
rows stay sorted.  Keys are int64 registers of at most 62 bits
(``convert.py``), counts int64.

The fold merges such tables once they are front-packed
(:func:`compact_counts`, kernel K10): :func:`merge_compact_tables` is K9's
merge-reduce, one pass that merges two sorted tables, sums equal keys and
front-packs the result (its plain version: K9's plain merge, the weighted
RLE, K10's plain compaction).  A CUDA tensor runs the kernels, a CPU tensor
their plain versions.
"""

from __future__ import annotations

import torch

from ..convert import KEY_BITS_MAX, SENTINEL
from ..utils.debug import checked_mode
from .kernels.merge_kernel import compact_table, merge_reduce_tables
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
    out.  Kernel K10 (``compact_table``)."""
    return compact_table(keys.contiguous(), counts.to(torch.int64).contiguous())


def merge_sorted_counts(keys_a, counts_a, keys_b, counts_b):
    """Merge two count tables of any order: concatenate, sort, and sum
    equal keys.  Returns ``(uniq, counts, n_unique)``,
    sentinel-interspersed."""
    keys = torch.cat([keys_a, keys_b])
    counts = torch.cat([counts_a, counts_b]).to(torch.int64)
    skeys, order = torch.sort(keys, stable=False)
    return _run_length_encode(skeys, counts[order])


def _check_sorted(name: str, keys: torch.Tensor) -> None:
    if keys.shape[0] > 1 and bool((keys[1:] < keys[:-1]).any()):
        raise ValueError(
            f"checked mode: merge_compact_tables takes sorted tables, but table "
            f"{name} is not sorted (front-pack a sentinel-interspersed table "
            "with compact_counts first)"
        )


def merge_compact_tables(keys_a, counts_a, keys_b, counts_b):
    """Merge two *sorted* count tables and sum equal keys.

    Precondition (the JAX contract): both tables are sorted ascending by
    key, with sentinel rows only at the tail, i.e. front-packed (as
    :func:`compact_counts` leaves them); checked mode verifies it and
    raises ``ValueError``.  K9's merge-reduce (``merge_reduce_tables``)
    merges them, sums equal keys and front-packs the result in one pass.
    Returns ``(keys, counts, n_unique)`` of length ``len(keys_a) +
    len(keys_b)``; the first ``n_unique`` rows are the merged table, the
    rest sentinel/0.
    """
    if checked_mode():
        _check_sorted("A", keys_a)
        _check_sorted("B", keys_b)
    return merge_reduce_tables(
        keys_a.contiguous(), counts_a.to(torch.int64).contiguous(),
        keys_b.contiguous(), counts_b.to(torch.int64).contiguous(),
    )
