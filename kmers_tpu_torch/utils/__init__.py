"""Checked mode, metrics, the level-stack accumulator, the drain queue,
count-table checkpoints and profiling hooks."""

from .checkpoint import input_manifest_entry, load_count_table, save_count_table
from .debug import checked, checked_mode, set_checked
from .levelstack import LevelStack
from .metrics import BatchStats, Metrics
from .profiling import annotate, count, counters, device_op_times, profile_step, reset_counters, trace
from .streamq import DrainQueue

__all__ = [
    "BatchStats",
    "DrainQueue",
    "LevelStack",
    "Metrics",
    "annotate",
    "checked",
    "checked_mode",
    "count",
    "counters",
    "device_op_times",
    "input_manifest_entry",
    "load_count_table",
    "profile_step",
    "reset_counters",
    "save_count_table",
    "set_checked",
    "trace",
]
