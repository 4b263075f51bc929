"""Mergesort-style level-stack accumulator.

Counterpart of ``kmers_tpu/utils/levelstack.py`` (not imported from there:
importing anything under ``kmers_tpu.utils`` imports jax).  A
binary-counter stack of one table per size level merges equal levels
pairwise: O(c u log c) merge work over c chunk tables of u distinct keys,
with at most log2(c) tables alive.  Any merge order gives the same table.
"""

from __future__ import annotations

__all__ = ["LevelStack"]


class LevelStack:
    """``merge(a, b)`` combines two tables into a raw merged output;
    ``slice_(out)`` trims it to its live rows.  ``push`` adds a level-0
    table and carries equal-level merges up like binary-counter addition;
    ``fold`` collapses the remaining levels smallest-first."""

    def __init__(self, merge, slice_):
        self._merge = merge
        self._slice = slice_
        self._stack: list[tuple[int, object]] = []  # (level, table)

    def __len__(self) -> int:
        return len(self._stack)

    def push(self, tbl) -> None:
        level = 0
        while self._stack and self._stack[-1][0] == level:
            _, other = self._stack.pop()
            tbl = self._slice(self._merge(other, tbl))
            level += 1
        self._stack.append((level, tbl))

    def fold(self):
        """Collapse the stack (top = smallest first); None when empty."""
        if not self._stack:
            return None
        tbl = self._stack.pop()[1]
        while self._stack:
            tbl = self._slice(self._merge(self._stack.pop()[1], tbl))
        return tbl
