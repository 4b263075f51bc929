"""Incremental canonical counting over unbounded inputs.

Counterpart of ``kmers_tpu/pipelines/streaming.py``.
:class:`StreamingCounter` keeps one device-resident level stack of count
tables across ``update()`` calls: push record batches as they are read,
finalize once.  With :func:`kmers_tpu_torch.io.stream_fastx` it counts
files larger than host memory without ever holding them
(:func:`count_fastx_stream`).

Each ``update()`` call is a record batch: windows never span two calls
(callers pass whole records; batch boundaries behave like record
boundaries).  Within a call, records are joined with 'N' separators, so
results are bit-identical to counting the concatenated input with
``canonical_count_records``.  A batch is uploaded once and its chunks are
views into it; every chunk's table is front-packed (kernel K10) before it
joins the stack, whose merges run K9, the weighted RLE and K10.
"""

from __future__ import annotations

import numpy as np

from ..ops.count import merge_compact_tables
from ..symbols import EncodeError
from ..utils.profiling import annotate
from ._input import ALPHABET, as_byte_array, download_table, join_records_with_n, resolve_device, upload
from ._stream import level_stack, push_chunks
from .canonical_count import CountConfig, _count_chunk

__all__ = ["StreamingCounter", "count_fastx_stream"]


class StreamingCounter:
    """Device-resident canonical K-mer counter with incremental updates.

    >>> sc = StreamingCounter(CountConfig(K=31), device="cpu")
    >>> for seq, off in stream_fastx("reads.fq.gz"):
    ...     sc.update(seq, off)
    >>> kmers, counts = sc.finalize()

    Peak device memory is O(distinct * log(batches)) table rows plus one
    batch and one chunk of windows, independent of the total input
    length.  K <= 31 (one-word tables).
    """

    def __init__(self, config: CountConfig = CountConfig(), metrics=None, device="cuda"):
        if config.K > 31:
            raise ValueError(
                "StreamingCounter supports K <= 31 (use "
                "canonical_count_bytes for multi-limb K)"
            )
        if not config.skip_ambiguous:
            raise ValueError("streaming counting requires skip_ambiguous=True")
        if config.resolved_chunk_size < config.K:
            raise ValueError("chunk_size must be >= K")
        self.config = config
        self.metrics = metrics
        self.device = resolve_device(device)
        self._stack = level_stack(merge_compact_tables)
        self._n_invalid = 0
        self._n_valid = 0  # Python int: unbounded window-conservation tally
        self._n_windows = 0
        self._bases = 0
        self._done = False
        if metrics is not None:
            metrics.start_batch()

    def update(self, seq_bytes, offsets=None):
        """Count one record batch.  ``offsets`` (optional int64 CSR
        record starts, as returned by the fastx readers) joins records
        with 'N' so windows never span records; without it the buffer is
        treated as a single record."""
        with annotate("kmers.update"):
            if self._done:
                raise RuntimeError("finalize() already called")
            arr = as_byte_array(seq_bytes)
            if offsets is not None:
                arr = join_records_with_n(arr, offsets)
            K = self.config.K
            L = arr.shape[0]
            self._bases += L
            if L < K:
                return
            self._n_windows += L - K + 1
            buf = upload(arr, self.device)
            # the checked tallies: n_valid feeds finalize()'s conservation check
            n_invalid, _n_ambig, n_valid, _n_counted = push_chunks(
                buf, K, self.config.resolved_chunk_size,
                lambda chunk: _count_chunk(chunk, K, True), self._stack,
            )
            self._n_invalid += n_invalid
            self._n_valid += n_valid

    @property
    def bases_seen(self) -> int:
        return self._bases

    def finalize(self):
        """Fold the accumulator and return sorted ``(kmers, counts)``.

        Raises :class:`~kmers_tpu_torch.symbols.EncodeError` if any invalid
        (non-IUPAC) byte was seen in any batch, and ``RuntimeError`` if
        window conservation fails: every valid window must be counted
        exactly once, so a mismatch means a kernel bug."""
        with annotate("kmers.finalize"):
            self._done = True
            if self._n_invalid:
                raise EncodeError(ALPHABET, "<stream input>")
            if not len(self._stack):
                return np.zeros(0, np.uint64), np.zeros(0, np.int64)
            keys, counts = self._stack.fold()
            # mask on the device, so only real rows cross to the host
            keep = counts > 0
            kmers, counts = download_table(keys[keep], counts[keep])
            counted = int(counts.sum())
            if counted != self._n_valid:
                raise RuntimeError(
                    f"window conservation violated: {self._n_valid} valid "
                    f"windows seen but {counted} counted — a kernel bug"
                )
            if self.metrics is not None:
                self.metrics.end_batch(
                    bases_in=self._bases,
                    windows_out=counted,
                    windows_skipped=self._n_windows - counted,
                    distinct_kmers=int(kmers.shape[0]),
                )
            return kmers, counts


def count_fastx_stream(
    path, config: CountConfig = CountConfig(), batch_bytes: int = 1 << 26, metrics=None,
    device="cuda",
):
    """Count canonical K-mers of a FASTA/FASTQ file without loading it:
    stream record batches through a :class:`StreamingCounter`.

    Bit-identical to ``canonical_count_records(*read_fastx(path))``, with
    O(batch) host memory.
    """
    from ..io import stream_fastx

    with annotate("kmers.count_fastx"):
        sc = StreamingCounter(config, metrics=metrics, device=device)
        for seq, off in stream_fastx(path, batch_bytes=batch_bytes):
            sc.update(seq, off)
        return sc.finalize()
