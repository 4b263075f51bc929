"""Checked mode, metrics, the level-stack accumulator and the drain queue."""

from .debug import checked, checked_mode, set_checked
from .levelstack import LevelStack
from .metrics import BatchStats, Metrics
from .streamq import DrainQueue

__all__ = [
    "BatchStats",
    "DrainQueue",
    "LevelStack",
    "Metrics",
    "checked",
    "checked_mode",
    "set_checked",
]
