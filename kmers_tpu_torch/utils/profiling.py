"""Profiling hooks on ``torch.profiler``.

Counterpart of ``kmers_tpu/utils/profiling.py`` (``jax.profiler`` there)::

    with trace("/tmp/kmer-trace"):
        with annotate("count"):
            canonical_count_bytes(data, CountConfig(K=31))
    device_op_times("/tmp/kmer-trace")   # {event name: total ms}

:func:`trace` records the host and, where CUDA is available, the device
(kernels, copies) and writes a Chrome trace (``*.pt.trace.json``) under its
directory; :func:`annotate` labels a region in that timeline and, on a CUDA
host, also opens an NVTX range for external profilers.
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

__all__ = ["trace", "annotate", "device_op_times", "profile_step"]


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


@contextlib.contextmanager
def annotate(name: str):
    """Label the enclosed block ``name`` in the trace (and, on a CUDA host,
    in an NVTX range)."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(record_function(name))
        yield


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
