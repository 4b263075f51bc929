"""Profiling hooks on ``torch.profiler``.

Counterpart of ``kmers_tpu/utils/profiling.py`` (``jax.profiler`` there)::

    with trace("/tmp/kmer-trace"):
        with annotate("count"):
            canonical_count_bytes(data, CountConfig(K=31))
    device_op_times("/tmp/kmer-trace")   # {event name: total ms}
    counters()                           # {"upload_bytes": ..., ...}

:func:`trace` records the host and, where CUDA is available, the device
(kernels, copies) and writes a Chrome trace (``*.pt.trace.json``) under its
directory.  :func:`annotate` is a span: it labels a region in that
timeline, on the profiler's clock, so the pipelines' spans (``kmers.*``)
sit beside the kernels and copies they issue.  :func:`count` adds to a
named counter.  Both act only while a torch profiler records; otherwise a
span is one check of the profiler's state and a counter is not touched.
:func:`pinned_empty_like` is the port's one pinned host allocation, with
its own span and counters.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = [
    "trace", "annotate", "count", "counters", "reset_counters", "device_op_times", "profile_step",
    "pinned_empty_like",
]

#: whether a torch profiler records (legacy or kineto): the spans' and
#: counters' gate, ~0.1 us a call against ~8 us for a ``record_function``
_profiler_enabled = torch._C._autograd._profiler_enabled

_NO_SPAN = contextlib.nullcontext()

#: counter name -> running total: an int, or a 0-d tensor summed on its device
_counters: dict = {}


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block (host, and the device when CUDA is
    available) and yield the ``torch.profiler.profile``; on exit write its
    Chrome trace under ``log_dir`` (nothing is written for ``None``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A span: label the enclosed block ``name`` in the trace
    (``record_function``) while a torch profiler records; a no-op
    otherwise.  Use as ``with annotate(name):``; spans of one thread nest."""
    if not _profiler_enabled():
        return _NO_SPAN
    return record_function(name)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a torch profiler records;
    a no-op otherwise.  ``value`` is an int, a 0-d integer tensor (summed
    on its device, not read until :func:`counters`), or a function of no
    arguments that returns one, called only while the profiler records."""
    if not _profiler_enabled():
        return
    if callable(value):
        value = value()
    total = _counters.get(name, 0)
    if isinstance(total, torch.Tensor) and isinstance(value, torch.Tensor):
        value = value.to(total.device, non_blocking=True)
    _counters[name] = total + value


def pinned_empty_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised host tensor shaped as ``t``, in pinned memory from
    torch's caching host allocator: every pinned allocation of the port
    passes here.  While a torch profiler records: span ``kmers.pin``
    around the allocation (``cudaHostAlloc`` when the cache grows),
    counter ``pinned_bytes`` (the bytes asked for) and ``pinned_new_bytes``
    (the growth of the allocator's ``allocated_bytes.allocated`` across
    the allocation: the bytes it had to pin anew, each new block rounded up
    to a power of two, so a miss can count more than it asked for; 0 when
    a cached block served the request).  A failed allocation raises and
    counts nothing."""
    if not _profiler_enabled():
        return torch.empty_like(t, device="cpu", pin_memory=True)
    with record_function("kmers.pin"):
        before = _pinned_total()
        host = torch.empty_like(t, device="cpu", pin_memory=True)
        count("pinned_bytes", host.nbytes)
        count("pinned_new_bytes", _pinned_total() - before)
    return host


def _pinned_total() -> int:
    """The bytes the caching host allocator has pinned since the process
    started (``torch.cuda.host_memory_stats()["allocated_bytes.allocated"]``,
    read from its nested form without the flattening); 0 before CUDA is
    initialised, when the stats are empty."""
    return torch.cuda.host_memory_stats_as_nested_dict().get("allocated_bytes", {}).get("allocated", 0)


def counters() -> dict[str, int]:
    """Every counter's total as an int (a device total is read here)."""
    return {name: int(v) for name, v in _counters.items()}


def reset_counters() -> None:
    """Clear every counter."""
    _counters.clear()


def device_op_times(log_dir: str) -> dict[str, float]:
    """Summed duration (ms) per event name of the newest trace under
    ``log_dir``: device kernels and copies under their own names, host
    operators under theirs."""
    paths = [
        p for pattern in ("*.trace.json", "*.trace.json.gz")
        for p in glob.glob(os.path.join(log_dir, "**", pattern), recursive=True)
    ]
    if not paths:
        return {}
    newest = max(paths, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    out: dict[str, float] = {}
    for e in events:
        if e.get("ph") == "X" and "dur" in e and "name" in e:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def profile_step(step, *args, reps: int = 2, top: int = 10):
    """Run ``step(*args)`` ``reps`` times under a trace and return the
    ``top`` event names by total duration: ``[(name, total_ms), ...]``.
    ``step`` should end in a synchronisation (a host read of a result), so
    that its device work lands inside the trace."""
    with tempfile.TemporaryDirectory(prefix="kmers-prof-") as d:
        with trace(d):
            for _ in range(reps):
                step(*args)
        times = device_op_times(d)
    return sorted(times.items(), key=lambda kv: -kv[1])[:top]
