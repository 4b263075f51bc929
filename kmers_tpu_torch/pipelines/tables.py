"""Count-table algebra: set and multiset operations on ``(kmers, counts)``
tables.

Counterpart of ``kmers_tpu/pipelines/tables.py``.  A count table is the
sorted ``(kmers, counts)`` pair that the counting pipelines return:

- :func:`merge_counts`: multiset sum (the dict-merge idiom);
- :func:`intersect_counts`: keys in both (count = min or sum);
- :func:`subtract_counts`: saturating multiset difference;
- :func:`multiplicity_spectrum`: the k-mer multiplicity histogram;
- :func:`jaccard_exact`, :func:`containment`: exact set similarities;
- :func:`merge_counts_device`: :func:`merge_counts` on the device, through
  the table fold of the counting pipelines (kernels K9 and K10).

The host functions are numpy (``merge_counts`` of two uint64 tables is the
native two-pointer merge of ``io/fasta.py``, as in the reference) and
accept uint64 tables (K <= 31) and object-dtype tables of Python ints
(K > 31); inputs must be sorted-unique, which every producer of the
package guarantees.
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import merge_count_tables_native
from ..ops.count import merge_compact_tables
from ._input import download_table, resolve_device, upload

__all__ = [
    "merge_counts",
    "intersect_counts",
    "subtract_counts",
    "multiplicity_spectrum",
    "merge_counts_device",
    "jaccard_exact",
    "containment",
]


def _check_table(kmers, counts):
    kmers = np.asarray(kmers)
    counts = np.asarray(counts, dtype=np.int64)
    if kmers.shape != counts.shape or kmers.ndim != 1:
        raise ValueError("a count table is a pair of equal-length 1-D arrays")
    return kmers, counts


def merge_counts(a_kmers, a_counts, b_kmers, b_counts):
    """Multiset sum of two count tables: every key from either table,
    counts added.  Returns a sorted-unique ``(kmers, counts)`` pair, the
    table the concatenated inputs would have counted to."""
    ak, ac = _check_table(a_kmers, a_counts)
    bk, bc = _check_table(b_kmers, b_counts)
    if ak.dtype == np.uint64 and bk.dtype == np.uint64:
        # the native two-pointer merge (numpy fallback inside), as the
        # reference merges uint64 tables
        return merge_count_tables_native(ak, ac, bk, bc)
    keys = np.concatenate([ak, bk])
    cnts = np.concatenate([ac, bc])
    uniq, inv = np.unique(keys, return_inverse=True)
    summed = np.zeros(uniq.size, np.int64)
    np.add.at(summed, inv, cnts)
    return uniq, summed


def intersect_counts(a_kmers, a_counts, b_kmers, b_counts, mode: str = "min"):
    """Keys present in *both* tables.  ``mode="min"`` gives the multiset
    intersection (count = min of the two); ``mode="sum"`` gives the total
    coverage of the shared keys."""
    if mode not in ("min", "sum"):
        raise ValueError("mode must be 'min' or 'sum'")
    ak, ac = _check_table(a_kmers, a_counts)
    bk, bc = _check_table(b_kmers, b_counts)
    common, ia, ib = np.intersect1d(ak, bk, assume_unique=True, return_indices=True)
    c = np.minimum(ac[ia], bc[ib]) if mode == "min" else ac[ia] + bc[ib]
    return common, c.astype(np.int64)


def subtract_counts(a_kmers, a_counts, b_kmers, b_counts):
    """Saturating multiset difference ``a - b``: counts of ``b`` are
    subtracted from ``a``; keys that reach zero (or below) drop out."""
    ak, ac = _check_table(a_kmers, a_counts)
    bk, bc = _check_table(b_kmers, b_counts)
    _, ia, ib = np.intersect1d(ak, bk, assume_unique=True, return_indices=True)
    rem = ac.copy()
    rem[ia] -= bc[ib]
    keep = rem > 0
    return ak[keep], rem[keep]


def multiplicity_spectrum(counts, max_multiplicity: int | None = None):
    """K-mer multiplicity histogram: ``spectrum[m]`` is the number of
    distinct k-mers occurring exactly ``m`` times (index 0 is always 0).
    With ``max_multiplicity`` the tail is clamped into the last bin and the
    spectrum always has exactly ``max_multiplicity + 1`` entries."""
    counts = np.asarray(counts, dtype=np.int64)
    minlength = 2
    if max_multiplicity is not None:
        counts = np.minimum(counts, max_multiplicity)
        minlength = max_multiplicity + 1
    return np.bincount(counts, minlength=minlength).astype(np.int64)


def jaccard_exact(a_kmers, b_kmers) -> float:
    """Exact Jaccard index of two tables' distinct-k-mer sets,
    |A ∩ B| / |A ∪ B| (the quantity ``jaccard`` estimates from MinHash
    sketches); 1.0 for two empty tables."""
    a = np.asarray(a_kmers)
    b = np.asarray(b_kmers)
    inter = np.intersect1d(a, b, assume_unique=True).size
    union = a.size + b.size - inter
    return float(inter / union) if union else 1.0


def containment(a_kmers, b_kmers) -> float:
    """Containment of A in B: |A ∩ B| / |A| (1.0 when every distinct k-mer
    of A occurs in B, and for an empty A)."""
    a = np.asarray(a_kmers)
    b = np.asarray(b_kmers)
    if a.size == 0:
        return 1.0
    return float(np.intersect1d(a, b, assume_unique=True).size / a.size)


def _upload_table(kmers, counts, device):
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    if (kmers >> np.uint64(62)).any():
        raise ValueError("merge_counts_device takes K <= 31 tables (keys below 2^62)")
    return upload(kmers.view(np.int64), device), upload(np.ascontiguousarray(counts, dtype=np.int64), device)


def merge_counts_device(a_kmers, a_counts, b_kmers, b_counts, device="cuda"):
    """:func:`merge_counts` on ``device``: uint64 keys go up as int64 (a
    K <= 31 register is below 2^62) and ``merge_compact_tables`` merges
    them (K9's merge-reduce on a CUDA device).  K <= 31
    tables only.  Returns ``(np.uint64, np.int64)``.

    Counts are int64 on the device, so no sum can wrap and no input falls
    back to the host (the JAX package's device merge counts in int32 and
    takes the host merge when a sum could pass 2^31); the result is the
    same."""
    device = resolve_device(device)
    ak, ac = _check_table(a_kmers, a_counts)
    bk, bc = _check_table(b_kmers, b_counts)
    keys, counts, n_unique = merge_compact_tables(
        *_upload_table(ak, ac, device), *_upload_table(bk, bc, device)
    )
    n = int(n_unique)
    return download_table(keys[:n], counts[:n])
