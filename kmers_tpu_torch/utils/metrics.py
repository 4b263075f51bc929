"""Per-batch pipeline statistics.

Counterpart of ``kmers_tpu/utils/metrics.py``, with the same fields:
bases in, windows out, windows skipped, distinct k-mers, wall seconds.
"""

from __future__ import annotations

import dataclasses
import json
import time

__all__ = ["BatchStats", "Metrics"]


@dataclasses.dataclass
class BatchStats:
    bases_in: int = 0
    windows_out: int = 0
    windows_skipped: int = 0
    distinct_kmers: int = 0
    seconds: float = 0.0

    @property
    def bases_per_sec(self) -> float:
        return self.bases_in / self.seconds if self.seconds else 0.0


class Metrics:
    """Accumulates BatchStats; ``summary()`` gives a JSON-able dict."""

    def __init__(self):
        self.batches: list[BatchStats] = []
        self._t0 = None

    def start_batch(self):
        self._t0 = time.perf_counter()

    def end_batch(self, **fields) -> BatchStats:
        dt = time.perf_counter() - self._t0 if self._t0 else 0.0
        stats = BatchStats(seconds=dt, **fields)
        self.batches.append(stats)
        self._t0 = None
        return stats

    def summary(self) -> dict:
        total = BatchStats()
        for b in self.batches:
            total.bases_in += b.bases_in
            total.windows_out += b.windows_out
            total.windows_skipped += b.windows_skipped
            total.distinct_kmers = max(total.distinct_kmers, b.distinct_kmers)
            total.seconds += b.seconds
        return {
            "n_batches": len(self.batches),
            **dataclasses.asdict(total),
            "bases_per_sec": total.bases_per_sec,
        }

    def dump(self) -> str:
        return json.dumps(self.summary())
