"""The program's own spans and counters in a traced run, per traced call.

The port labels each layer boundary with a span (``kmers.*``, a
``record_function`` of ``kmers_tpu_torch/utils/profiling.py::annotate``),
so its spans are host events of the calling thread in the
:class:`~kmer_bench.trace.Trace`.  Its counters
(``kmers_tpu_torch.utils.profiling.counters()``) grow only while a
profiler records, and the harness starts the profiler after the warm-up,
so their totals cover exactly the traced calls.  A program that has no
such span or counter gives None, never 0.
"""

from __future__ import annotations


def host_ms(tr, name: str) -> float | None:
    """Summed ms per traced call of the host events named ``name``, clipped
    to the traced window; None when there is none."""
    a, b = tr.window
    times = [min(e, b) - max(s, a) for n, s, e in tr.host if n == name and s < b and e > a]
    if not times or not tr.calls:
        return None
    return sum(times) / 1e3 / tr.n_calls


def counter(tr, name: str) -> float | None:
    """The program's counter ``name`` per traced call; None when the
    program keeps no counters or not this one."""
    try:
        from kmers_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    total = read().get(name) if read is not None else None
    if total is None or not tr.calls:
        return None
    return total / tr.n_calls
