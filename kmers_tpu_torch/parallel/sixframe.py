"""Sharded six-frame amino-acid k-mer counting over a :class:`~.mesh.Mesh`.

Counterpart of ``kmers_tpu/parallel/sixframe.py``.  Each rank counts the
windows it owns on the single-device six-frame machinery
(``pipelines/sixframe.py::_count_chunk``: kernel K4 and ``sort_count``
for K <= 7, kernel K5 and ``sort_count_mw`` for 8 <= K <= 32), folds its
chunk tables on the device, and the final tables meet in one hash-prefix
exchange (``pipeline.py``'s, with ``multiword.py``'s merge for word
tables).

The geometry is the reference's, kept exactly, because each rank must
hold the same multiset as the reference's device: the bucket overflow is
decided on each rank's own table.

- ``shard = ceil(L / n)`` rounded up to a multiple of 3, so codon frames
  align alike on every rank; rank ``d``'s slab is the input's bytes
  ``[d * shard - H, (d + 1) * shard + H)``, ``H = 3K``, with 0x00 (an
  invalid byte: no window over it is emitted) outside the input.
- A rank emits the forward windows whose anchor lies in ``[H, H + shard)``
  of its slab and the reverse windows whose *forward* anchor lies in
  ``[1, shard + 1)``: the reference's fused bounds ``(H, H + b, 1, b + 1)``
  (its unfused span over the reversed stream is the same set).  So a
  rank's reverse windows start 3K - 1 bases before its forward ones.
- Within a rank the slab streams in chunks of ``chunk_size`` bytes that
  overlap by 3K - 1 (``_stream.count_stream``), each chunk's bounds the
  rank's ownership shifted to the chunk's start; chunk ``c`` emits only
  anchors of its own span, so no anchor is counted in two chunks.

The reference always takes its streamed route here, so the bucket
capacity comes from the largest rank's folded table: ``cap = ceil(C *
bucket_factor / n)``, ``C`` the next power of two of its distinct count.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..convert import words_to_ints
from ..genetic_codes import GeneticCode, standard_genetic_code
from ..ops.count import merge_compact_tables
from ..ops.kernels.sixframe_kernel import K4_MAX
from ..ops.multiword import _lex_order, fx_hash_mw, merge_compact_tables_mw
from ..pipelines._input import as_byte_array, download_table
from ..pipelines._stream import count_stream
from ..pipelines.sixframe import _count_chunk
from ..utils.debug import checked_mode
from .mesh import Mesh, data_mesh
from .multiword import _merge_words
from .pipeline import OVERFLOW_MESSAGE, _exchange, _gather_rows, _next_pow2, exchange_and_merge

__all__ = ["SixFrameCountConfig", "sharded_sixframe_aa_count"]


@dataclasses.dataclass(frozen=True)
class SixFrameCountConfig:
    """The JAX sharded ``SixFrameCountConfig`` without ``use_pallas``,
    ``fused_fe`` and ``pallas_interpret``: the device decides."""

    K: int = 7  # amino acids per k-mer
    #: per-destination bucket capacity as a multiple of the uniform share;
    #: overflow is detected and raised, never dropped
    bucket_factor: float = 2.0
    code: GeneticCode = standard_genetic_code
    #: bytes a rank counts at a time; longer slabs stream in chunks
    chunk_size: int = 1 << 20

    def __post_init__(self):
        if not 1 <= self.K <= 32:
            raise ValueError(
                "sharded AA counting supports 1 <= K <= 32 (K <= 7 on "
                "single 56-bit registers, K <= 32 on multi-limb registers)"
            )
        if self.chunk_size < 6 * self.K:
            raise ValueError("chunk_size must be >= 6*K bases")


def _sixframe_slabs(arr: np.ndarray, n_dev: int, K: int):
    """The ranks' slabs, ``(n_dev, shard + 6K)`` uint8 with 0x00 outside
    the input, and ``shard``."""
    H = 3 * K
    shard = -(-arr.shape[0] // n_dev)
    shard += (-shard) % 3
    rows = np.zeros((n_dev, shard + 2 * H), dtype=np.uint8)
    for d in range(n_dev):
        lo = d * shard - H
        part = arr[max(lo, 0) : (d + 1) * shard + H]
        rows[d, max(-lo, 0) : max(-lo, 0) + part.shape[0]] = part
    return rows, shard


def _count_slab(slab: torch.Tensor, shard: int, config: SixFrameCountConfig, checked: bool):
    """One rank's folded table and its tallies ``[n_valid(, n_counted)]``."""
    H = 3 * config.K

    def count_chunk(chunk):
        # count_stream hands over views of the slab: their offset is the
        # chunk's start, and the rank's ownership shifts by it
        start = chunk.storage_offset() - slab.storage_offset()
        bounds = (H - start, H + shard - start, 1 - start, shard + 1 - start)
        return _count_chunk(chunk, config, checked, bounds)

    merge = merge_compact_tables if config.K <= K4_MAX else merge_compact_tables_mw
    return count_stream(slab, 3 * config.K, config.chunk_size, count_chunk, merge)


def _exchange_tables(tables: list, mesh: Mesh, cap: int, K: int):
    if K <= K4_MAX:
        # a 56-bit key hashes as one 64-bit word, as fx_hash_u64(hi, lo)
        return exchange_and_merge(tables, mesh, cap)
    return _exchange(tables, mesh, cap, lambda words: fx_hash_mw(words, K, bps=8), _merge_words)


def sharded_sixframe_aa_count(data, config: SixFrameCountConfig = SixFrameCountConfig(),
                              mesh: Mesh | None = None, metrics=None):
    """Count the amino-acid K-mers of all six reading frames of ``data``
    across the ranks of ``mesh`` (default: :func:`~.mesh.data_mesh`, every
    GPU).

    Returns ``(kmers, counts)`` sorted, on every process of a
    process-group mesh, as the reference returns them: ``np.uint64`` for
    K <= 7, an object array of Python ints for K > 7, and ``np.int64``
    counts; an input shorter than 3K gives ``np.zeros(0, np.uint64)`` at
    every K.  Ambiguous and invalid bytes only invalidate the windows that
    touch them.  Raises ``RuntimeError`` on bucket overflow (raise
    ``bucket_factor``).  Checked mode adds both count-conservation checks
    of the reference; ``metrics`` (an optional
    :class:`~kmers_tpu_torch.utils.Metrics`) records one batch.
    """
    if metrics is not None:
        metrics.start_batch()
    arr = as_byte_array(data)
    if mesh is None:
        mesh = data_mesh()
    K = config.K
    L = arr.shape[0]
    if L < 3 * K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    checked = checked_mode()
    rows, shard = _sixframe_slabs(arr, mesh.size, K)
    slabs = mesh.put(rows)
    del rows
    tables, tallies, distinct = [], [], []
    for slab in slabs:
        table, sums = _count_slab(slab, shard, config, checked)
        tables.append(table)
        tallies.append(sums if checked else sums + [0])
        distinct.append((table[1] > 0).sum())
    del slabs
    n_valid, n_counted = mesh.sum(tallies)
    (most,) = mesh.max(distinct)
    cap = max(math.ceil(_next_pow2(max(most, 1)) * config.bucket_factor / mesh.size), 1)
    merged, overflow = _exchange_tables(tables, mesh, cap, K)
    del tables
    # the reference's messages name its multi-limb route for K > 7
    where = "six-frame" if K <= K4_MAX else "multi-limb six-frame"
    if checked and n_valid != n_counted:
        raise RuntimeError(
            f"checked mode: count conservation violated in the {where} local count — "
            f"{n_valid} valid windows but {n_counted} counted"
        )
    if overflow > 0:
        raise RuntimeError(OVERFLOW_MESSAGE)

    rows = _gather_rows(merged, mesh)
    counts = rows[:, -1]
    if K <= K4_MAX:
        keys = rows[:, 0]
        if mesh.size > 1:
            keys, order = torch.sort(keys)
            counts = counts[order]
    else:
        keys = rows[:, :-1].T.contiguous()
        order = _lex_order(keys)
        keys, counts = keys[:, order], counts[order]
    kmers, counts = download_table(keys.contiguous(), counts.contiguous())
    if K > K4_MAX:
        kmers = words_to_ints(kmers.T)
    if checked and int(counts.sum()) != n_valid:
        raise RuntimeError(
            f"checked mode: count conservation violated across the {where} exchange — "
            f"{n_valid} valid windows but {int(counts.sum())} in the merged table"
        )
    if metrics is not None:
        # 2(L - 3K + 1) six-frame windows exist; skipped = the invalid ones
        metrics.end_batch(
            bases_in=L,
            windows_out=int(counts.sum()),
            windows_skipped=2 * (L - 3 * K + 1) - n_valid,
            distinct_kmers=int(kmers.shape[0]),
        )
    return kmers, counts
