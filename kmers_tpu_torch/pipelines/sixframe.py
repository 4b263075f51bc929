"""Six-frame amino-acid k-mer counting on one device.

Counterpart of ``kmers_tpu/parallel/sixframe.py::sharded_sixframe_aa_count``
over ``data_mesh(1)``; the sharded form is ``parallel/sixframe.py``, whose
ranks count their slabs with :func:`_count_chunk`.  Every window of K
codons, over both strands and all three frames, whose 3K bases are all
certain (A/C/G/T/U, either case) is counted; ambiguous and invalid bytes
only invalidate the windows that touch them, and never raise.

The input is uploaded once and counted in chunks of ``chunk_size`` bytes
that overlap by 3K - 1 (``_stream.count_stream`` with a span of 3K): a
chunk owns the anchors ``[0, len - 3K + 1)`` of both strands, and windows
that run past its end are invalid.  A CUDA device runs the kernels, a CPU
device their plain versions:

- K <= 7: K4 (``sixframe_windows``: one int64 key a window), then
  ``sort_count`` (``torch.sort`` + K2); tables merge with
  ``merge_compact_tables``;
- 8 <= K <= 32: K5 (``sixframe_words``: ``ceil(8K / 62)`` int64 words a
  window), then ``sort_count_mw`` (W stable sorts, run ids, K2); tables
  merge with ``merge_compact_tables_mw``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import words_to_ints
from ..genetic_codes import GeneticCode, standard_genetic_code
from ..ops.count import merge_compact_tables, sort_count
from ..ops.kernels.sixframe_kernel import K4_MAX, sixframe_windows, sixframe_words
from ..ops.multiword import merge_compact_tables_mw, sort_count_mw
from ..utils.debug import checked_mode
from ..utils.profiling import annotate, count
from ._input import as_byte_array, download_table, real_rows, resolve_device, upload
from ._stream import count_stream

__all__ = ["SixFrameCountConfig", "sixframe_aa_count"]


@dataclasses.dataclass(frozen=True)
class SixFrameCountConfig:
    """Six-frame counting configuration (the JAX ``SixFrameCountConfig``
    without its TPU fields: ``bucket_factor``, ``use_pallas``,
    ``fused_fe`` and ``pallas_interpret`` have no meaning on one device)."""

    K: int = 7  # amino acids per k-mer
    #: bytes per chunk
    chunk_size: int = 1 << 20
    code: GeneticCode = standard_genetic_code

    def __post_init__(self):
        if not 1 <= self.K <= 32:
            raise ValueError(
                "sharded AA counting supports 1 <= K <= 32 (K <= 7 on "
                "single 56-bit registers, K <= 32 on multi-limb registers)"
            )
        if self.chunk_size < 6 * self.K:
            raise ValueError("chunk_size must be >= 6*K bases")


def _count_chunk(chunk: torch.Tensor, config, track: bool, bounds=None):
    """One chunk: ``((uniq, counts), [n_unique, n_valid(, n_counted)])``.
    ``bounds``: the anchors each strand emits (K4's and K5's), by default
    every anchor of the chunk."""
    K = config.K
    if bounds is None:
        bounds = (0, chunk.shape[0], 0, chunk.shape[0])
    if K <= K4_MAX:
        keys, n_valid = sixframe_windows(chunk, K, bounds, config.code)
        uniq, counts, n_unique = sort_count(keys, key_bits=8 * K)
    else:
        words, n_valid = sixframe_words(chunk, K, bounds, config.code)
        uniq, counts, n_unique = sort_count_mw(words)
    scalars = [n_unique, n_valid]
    if track:
        scalars.append(counts.sum())
    return (uniq, counts), torch.stack(scalars)


def sixframe_aa_count(
    data, config: SixFrameCountConfig = SixFrameCountConfig(), metrics=None,
    device="cuda",
):
    """Count the amino-acid K-mers of all six reading frames of an ASCII
    nucleotide buffer on ``device``.

    Returns ``(kmers, counts)`` sorted, as the JAX package returns them:
    for K <= 7 ``kmers`` is ``np.uint64`` (8 bits an amino acid, the
    earliest codon highest), for K > 7 an object array of Python ints of
    the same layout; ``counts`` is ``np.int64``.  An input shorter than 3K
    gives ``np.zeros(0, np.uint64), np.zeros(0, np.int64)`` at every K.
    ``metrics``: an optional :class:`~kmers_tpu_torch.utils.Metrics` that
    records one batch, as the reference's.  Checked mode verifies that
    every emitted window is counted once.  Root span ``kmers.sixframe``;
    counter ``aa_windows``: the windows counted.
    """
    with annotate("kmers.sixframe"):
        return _sixframe_aa_count(data, config, metrics, resolve_device(device))


def _sixframe_aa_count(data, config: SixFrameCountConfig, metrics, device):
    if metrics is not None:
        metrics.start_batch()
    arr = as_byte_array(data)
    K = config.K
    L = arr.shape[0]
    if L < 3 * K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    buf = upload(arr, device)
    checked = checked_mode()
    merge = merge_compact_tables if K <= K4_MAX else merge_compact_tables_mw
    acc, tallies = count_stream(
        buf, 3 * K, config.chunk_size, lambda c: _count_chunk(c, config, checked), merge
    )
    n_valid = tallies[0]
    count("aa_windows", n_valid)
    if checked and n_valid != tallies[1]:
        raise RuntimeError(
            "checked mode: count conservation violated in the six-frame "
            f"local count — {n_valid} valid windows but {tallies[1]} counted"
        )

    kmers, counts = download_table(*real_rows(*acc))
    if K > K4_MAX:
        kmers = words_to_ints(kmers.T)
    if metrics is not None:
        # 2(L - 3K + 1) six-frame windows exist; skipped = the invalid ones
        metrics.end_batch(
            bases_in=L,
            windows_out=int(counts.sum()),
            windows_skipped=2 * (L - 3 * K + 1) - n_valid,
            distinct_kmers=int(kmers.shape[0]),
        )
    return kmers, counts
