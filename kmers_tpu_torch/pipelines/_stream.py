"""The chunk loop shared by the counting pipelines (canonical and
six-frame): overlapping chunks of one uploaded buffer, each counted into
a table, folded on the device through a level stack of merges."""

from __future__ import annotations

import torch

from ..ops.count import compact_counts
from ..utils.levelstack import LevelStack
from ..utils.streamq import DrainQueue

__all__ = ["count_stream"]


def count_stream(buf: torch.Tensor, span: int, chunk_size: int, count_chunk, merge):
    """Count the overlapping chunks of ``buf`` and fold their tables.

    ``span`` is the bytes a window covers (K for nucleotides, 3K for
    amino acids); consecutive chunks share ``span - 1`` bytes, so no
    window is lost at a boundary, and each chunk sentinels its own windows
    that run past its end, so none is counted twice.  ``count_chunk(view)``
    gives ``((keys, counts), scalars)`` with ``scalars[0]`` the distinct
    count; ``merge(ka, ca, kb, cb)`` gives a front-packed ``(keys, counts,
    n_unique)``.  Keys are ``(n,)`` or ``(W, n)``.  Returns ``(table,
    tallies)``: the table (interspersed when there was one chunk) and the
    sums of ``scalars[1:]`` as ints.
    """
    starts = range(0, max(buf.shape[0] - span + 1, 1), chunk_size - (span - 1))
    if len(starts) == 1:
        # one chunk: no compaction, no merge; the final mask drops padding
        table, scalars = count_chunk(buf)
        return table, scalars.tolist()[1:]

    tallies = None

    def _slice(out):
        keys, counts, n_unique = out
        nu = int(n_unique)  # the merge's one host round trip
        return keys[..., :nu], counts[:nu]

    stack = LevelStack(lambda a, b: merge(*a, *b), _slice)

    def _drain(out, values):
        nonlocal tallies
        nu, rest = values[0], values[1:]
        tallies = rest if tallies is None else [t + v for t, v in zip(tallies, rest)]
        keys, counts = compact_counts(*out)
        stack.push((keys[..., :nu], counts[:nu]))

    queue = DrainQueue(_drain)
    for start in starts:
        queue.push(*count_chunk(buf[start : start + chunk_size]))
    queue.flush()
    return stack.fold(), tallies
