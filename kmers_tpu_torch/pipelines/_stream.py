"""The chunk loop shared by the counting pipelines (canonical, six-frame
and streaming): overlapping chunks of one uploaded buffer, each counted
into a table, front-packed, and folded on the device through a level stack
of merges.

The merge (``merge_compact_tables``: K9's merge-reduce, one pass that
merges, sums equal keys and front-packs; or its multi-word form) takes two
*sorted* tables, with padding rows only at the tail.  A chunk's own table
is sentinel-interspersed (padding between its real rows), so every table
pushed on a level stack is front-packed by ``compact_counts`` (K10) first.  The one-chunk shortcut of
:func:`count_stream` returns a chunk's table as it is, interspersed; such a
table must never feed a level stack, since K9 would then merge an unsorted
input.  :func:`push_chunks`, which a caller with its own stack uses, has no
shortcut.
"""

from __future__ import annotations

import torch

from ..ops.count import compact_counts
from ..utils.levelstack import LevelStack
from ..utils.profiling import annotate
from ..utils.streamq import DrainQueue

__all__ = ["count_stream", "level_stack", "push_chunks"]


def _starts(n: int, span: int, chunk_size: int) -> range:
    # consecutive chunks share span - 1 bytes
    return range(0, max(n - span + 1, 1), chunk_size - (span - 1))


def level_stack(merge) -> LevelStack:
    """A level stack of front-packed ``(keys, counts)`` tables folded by
    ``merge(ka, ca, kb, cb) -> (keys, counts, n_unique)``; each merged
    table is cut to its ``n_unique`` live rows (one host round trip).
    Span ``kmers.fold`` a merge and its cut, ``kmers.wait`` the read."""

    def _fold(a, b):
        with annotate("kmers.fold"):
            keys, counts, n_unique = merge(*a, *b)
            with annotate("kmers.wait"):
                nu = int(n_unique)
            return keys[..., :nu], counts[:nu]

    # the cut is inside the merge's span, so the stack's own cut is the identity
    return LevelStack(_fold, lambda table: table)


def push_chunks(buf: torch.Tensor, span: int, chunk_size: int, count_chunk, stack) -> list:
    """Count the overlapping chunks of ``buf`` and push each table,
    front-packed and cut to its distinct rows, on ``stack`` (span
    ``kmers.drain`` a table: K10, the cut and the push, whose merges are
    ``kmers.fold`` spans inside it).

    ``span`` is the bytes a window covers (K for nucleotides, 3K for
    amino acids); each chunk sentinels its own windows that run past its
    end, so no window is lost at a boundary or counted twice.
    ``count_chunk(view)`` gives ``((keys, counts), scalars)`` with
    ``scalars[0]`` the distinct count.  Returns the sums of
    ``scalars[1:]`` as ints.
    """
    tallies = None

    def _drain(out, values):
        nonlocal tallies
        nu, rest = values[0], values[1:]
        tallies = rest if tallies is None else [t + v for t, v in zip(tallies, rest)]
        with annotate("kmers.drain"):
            keys, counts = compact_counts(*out)
            stack.push((keys[..., :nu], counts[:nu]))

    queue = DrainQueue(_drain)
    for start in _starts(buf.shape[0], span, chunk_size):
        with annotate("kmers.chunk"):
            out = count_chunk(buf[start : start + chunk_size])
        queue.push(*out)
    queue.flush()
    return tallies


def count_stream(buf: torch.Tensor, span: int, chunk_size: int, count_chunk, merge):
    """Count the chunks of ``buf`` (see :func:`push_chunks`) and fold
    their tables with ``merge``.  Keys are ``(n,)`` or ``(W, n)``.
    Returns ``(table, tallies)``: the table (interspersed when there was
    one chunk) and the sums of ``scalars[1:]`` as ints.
    """
    if len(_starts(buf.shape[0], span, chunk_size)) == 1:
        # one chunk: no compaction, no merge; the final mask drops padding
        with annotate("kmers.chunk"):
            table, scalars = count_chunk(buf)
        with annotate("kmers.wait"):
            tallies = scalars.tolist()[1:]
        return table, tallies
    stack = level_stack(merge)
    tallies = push_chunks(buf, span, chunk_size, count_chunk, stack)
    return stack.fold(), tallies
