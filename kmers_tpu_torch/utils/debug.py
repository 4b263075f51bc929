"""Checked mode: turn silently wrong results into loud errors.

Counterpart of ``kmers_tpu/utils/debug.py``, read from the same
``KMERS_TPU_CHECKED`` environment variable.  In checked mode the counting
pipeline verifies count conservation: every valid window is counted
exactly once (one extra reduction per chunk).
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["checked_mode", "set_checked", "checked"]

_checked: bool = os.environ.get("KMERS_TPU_CHECKED", "").lower() in (
    "1",
    "true",
    "yes",
    "on",
)


def checked_mode() -> bool:
    """True when checked mode is on."""
    return _checked


def set_checked(on: bool) -> None:
    """Turn checked mode on or off process-wide."""
    global _checked
    _checked = bool(on)


@contextlib.contextmanager
def checked(on: bool = True):
    """Turn checked mode on (or off) for the duration of a block."""
    global _checked
    prev = _checked
    _checked = bool(on)
    try:
        yield
    finally:
        _checked = prev
