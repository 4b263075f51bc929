"""Pipelined chunk-drain queue for the streamed counting driver.

Counterpart of ``kmers_tpu/utils/streamq.py``.  Up to :data:`DEPTH` chunk
outputs stay in flight; each carries one small int64 tensor of the scalars
its drain reads (distinct count, tallies).  For a CUDA tensor ``push``
queues a ``non_blocking`` copy of those scalars into pinned host memory and
records a CUDA event behind it, so by the time the oldest output is drained
the values have arrived and reading them does not stall the stream.
(The JAX queue's ``copy_to_host_async`` does not exist on a torch tensor.)
"""

from __future__ import annotations

from collections import deque

import torch

from .profiling import annotate, pinned_empty_like

__all__ = ["DrainQueue", "DEPTH"]

#: chunk outputs kept in flight before the oldest is drained
DEPTH = 8


class DrainQueue:
    """``push(out, scalars)`` enqueues one chunk's output and prefetches its
    1-D int64 ``scalars`` (span ``kmers.prefetch``: the pinned allocation,
    the copy and its event); when more than :data:`DEPTH` outputs are in
    flight the oldest is passed to ``drain_fn(out, values)`` with ``values``
    the scalars as a list of Python ints (span ``kmers.wait`` the read).
    ``flush()`` drains the rest in order."""

    def __init__(self, drain_fn):
        self._drain = drain_fn
        self._pending: deque = deque()

    def push(self, out, scalars: torch.Tensor) -> None:
        ready = None
        if scalars.is_cuda:
            with annotate("kmers.prefetch"):
                host = pinned_empty_like(scalars)
                host.copy_(scalars, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            scalars = host
        self._pending.append((out, scalars, ready))
        if len(self._pending) > DEPTH:
            self._drain_oldest()

    def _drain_oldest(self) -> None:
        out, scalars, ready = self._pending.popleft()
        with annotate("kmers.wait"):
            if ready is not None:
                ready.synchronize()
            values = scalars.tolist()
        self._drain(out, values)

    def flush(self) -> None:
        while self._pending:
            self._drain_oldest()
