"""Sharded canonical counting for K > 31 (multi-word registers).

Counterpart of ``kmers_tpu/parallel/multiword.py``: the exchange of
:mod:`.pipeline` over ``(W, n)`` word tables (``convert.py``).  Each rank
counts its slab in one dispatch with the single-device multi-word chunk
path, ``canonical_count._count_chunk_mw`` (kernel K3 for 32 <= K <= 63,
plain torch above, then the lexicographic sort and K2 over run ids); rows
are routed by :func:`~kmers_tpu_torch.ops.multiword.fx_hash_mw`, and each
rank sorts what it receives lexicographically (an unsorted pile, so a
sort, not the word fold's merge), then counts it by run ids and the
weighted RLE.  Padding is a count of
0; the port's words keep :data:`SENTINEL` free at every K, so no validity
limb is carried.  As in the reference, no metrics batch is recorded and
checked mode adds no check here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..convert import SENTINEL, words_to_ints
from ..ops.count import _run_length_encode
from ..ops.multiword import _lex_order, _run_ids, fx_hash_mw
from ..pipelines._input import ALPHABET, as_byte_array, download_table
from ..pipelines.canonical_count import _count_chunk_mw
from ..symbols import EncodeError
from ..utils.profiling import annotate
from .mesh import Mesh, data_mesh
from .pipeline import OVERFLOW_MESSAGE, _exchange, _gather_rows, _shard_with_halo

__all__ = ["exchange_and_merge_mw", "sharded_canonical_count_mw"]


def _merge_words(received: torch.Tensor):
    """Sort the received ``(m, W + 1)`` rows lexicographically and sum
    equal registers: ``(words, counts, n_unique)``, sentinel-interspersed."""
    words = received[:, :-1].T.contiguous()
    order = _lex_order(words)
    swords = words[:, order]
    _, totals, n_unique = _run_length_encode(_run_ids(swords), received[:, -1][order])
    return torch.where(totals > 0, swords, SENTINEL), totals, n_unique


def exchange_and_merge_mw(tables: list, mesh: Mesh, cap: int, K: int):
    """:func:`~.pipeline.exchange_and_merge` for ``(W, n)`` word tables of
    K-mers (K > 31), routed by ``fx_hash_mw``.  Returns ``(merged,
    overflow)``: per local rank ``(words, counts, n_unique)``, and the real
    rows past ``cap`` summed over the mesh."""
    return _exchange(tables, mesh, cap, lambda words: fx_hash_mw(words, K), _merge_words)


def sharded_canonical_count_mw(data, K: int = 63, mesh: Mesh | None = None,
                               bucket_factor: float = 2.0):
    """Count canonical K-mers (31 < K <= 100) across the ranks of ``mesh``.

    Returns ``(kmers, counts)``: a sorted object array of Python-int
    registers and ``np.int64`` counts, equal to single-device
    ``canonical_count_bytes``.  K <= 31 raises ``ValueError``; invalid
    bytes raise ``EncodeError`` (ambiguous ones are skipped); bucket
    overflow raises ``RuntimeError``.
    """
    if K <= 31:
        raise ValueError("use sharded_canonical_count for K <= 31")
    arr = as_byte_array(data)
    if mesh is None:
        mesh = data_mesh()
    L = arr.shape[0]
    if L < K:
        return np.zeros(0, object), np.zeros(0, np.int64)
    # the reference pads with an invalid byte and subtracts the padding from
    # its invalid count; padding with 'N' (skipped) decides the same
    rows, shard = _shard_with_halo(arr, mesh.size, K, pad_byte=ord("N"))
    cap = math.ceil(shard * bucket_factor / mesh.size)
    tables, invalid = [], []
    for slab in mesh.put(rows):
        table, scalars = _count_chunk_mw(slab, K)
        tables.append(table)
        invalid.append(scalars[1])
    del rows
    (n_bad,) = mesh.sum(invalid)
    merged, overflow = exchange_and_merge_mw(tables, mesh, cap, K)
    if n_bad > 0:
        raise EncodeError(ALPHABET, "<batch input>")
    if overflow > 0:
        raise RuntimeError(OVERFLOW_MESSAGE)
    rows = _gather_rows(merged, mesh)
    with annotate("kmers.rows"):
        words = rows[:, :-1].T.contiguous()
        order = _lex_order(words)
        words, counts = words[:, order], rows[:, -1][order]
    words, counts = download_table(words, counts)
    return words_to_ints(words.T), counts
