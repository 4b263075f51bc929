"""From a ``torch.profiler`` trace to per-layer numbers: the yardstick's
reduction.

:func:`capture` turns the profiler's events into plain tuples, so that
every reduction below also runs on a synthetic event list.  A
:class:`Trace` holds, for the traced calls of one process: the device's
operations (kernels, copies, sets), the host's operations on the calling
thread, the calls' own spans and the harness's other spans.

- ``busy`` is the union of the device operations' intervals inside the
  traced window (from the first traced call's start to the last one's
  end); the idle share is the rest of that window.
- ``group_ms`` sums the device time of the operations whose name a layer
  claims, per traced call.
- ``roofline_pct`` is the least time the bytes a kernel must move take at
  the card's peak bandwidth, over the kernel's device time.
"""

from __future__ import annotations

import collections
import dataclasses

#: published peak memory bandwidth (bytes/s) by ``torch.cuda.get_device_name``
#: (NVIDIA's H100 SXM data sheet, at its 700 W limit)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

CALL = "kb.call"


@dataclasses.dataclass
class Trace:
    """Events in microseconds: ``device`` and ``host`` are ``(name, start,
    end)``; ``calls`` are ``(start, end)`` of each traced call; ``spans``
    maps a harness span's name to its durations in seconds; ``work`` holds
    the traced calls' summed work counters; ``card`` is the device's name."""

    device: list
    host: list
    calls: list
    spans: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    card: str = ""

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def window(self) -> tuple:
        return (self.calls[0][0], self.calls[-1][1]) if self.calls else (0.0, 0.0)

    @property
    def window_us(self) -> float:
        a, b = self.window
        return b - a

    def intervals(self) -> list:
        """The device operations' intervals clipped to the window, merged."""
        a, b = self.window
        spans = sorted((max(s, a), min(e, b)) for _, s, e in self.device if e > a and s < b)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.intervals())


def capture(prof, spans: dict, work: dict, card: str) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``: device
    operations, and the host operations of the thread that ran the calls."""
    from torch.autograd import DeviceType

    device, host, calls = [], [], []
    cpu = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith("kb."):
                device.append((name, start, end))
        elif name == CALL:
            calls.append((start, end))
            cpu.append((name, start, end, e.start_thread_id()))
        else:
            cpu.append((name, start, end, e.start_thread_id()))
    threads = {t for n, _, _, t in cpu if n == CALL}
    host = [(n, s, e) for n, s, e, t in cpu if t in threads]
    return Trace(sorted(device, key=lambda x: x[1]), sorted(host, key=lambda x: (x[1], -x[2])),
                 sorted(calls), spans, work, card)


def idle_pct(tr: Trace):
    """Share of the traced window in which the device ran nothing (%)."""
    if not tr.calls or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)


def group_ms(tr: Trace, claims) -> float | None:
    """Device ms per traced call of the operations whose name ``claims``
    accepts; None when no such operation ran."""
    a, b = tr.window
    times = [e - s for n, s, e in tr.device if claims(n) and s < b and e > a]
    if not times or not tr.calls:
        return None
    return sum(times) / 1e3 / tr.n_calls


def roofline_pct(tr: Trace, claims, bytes_per_position: int, positions: str) -> float | None:
    """Share (%) of the kernel's device time that moving its bytes takes
    at the card's peak: ``bytes_per_position`` for each of the traced
    calls' ``work[positions]`` positions.  None when the kernel did not run
    or the card's peak is not in :data:`PEAK_BYTES_PER_S`."""
    ms = group_ms(tr, claims)
    peak = PEAK_BYTES_PER_S.get(tr.card)
    if ms is None or peak is None or not tr.work.get(positions):
        return None
    bound_s = bytes_per_position * tr.work[positions] / peak
    return 100.0 * bound_s / (ms / 1e3 * tr.n_calls)


def span_ms(tr: Trace, name: str) -> float | None:
    """A harness span's summed time per traced call (ms)."""
    secs = tr.spans.get(name)
    if not secs or not tr.calls:
        return None
    return 1e3 * sum(secs) / tr.n_calls


def _innermost(host: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the innermost host
    operation running then (None where none was).  Operations of one
    thread nest, so one sweep with a stack finds them."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][1] <= t:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps inside
    the traced window summed by what the host was running at their middle:
    ``{"device_ops": [[name, seconds], ...], "idle_gaps": [...]}``."""
    a, b = tr.window
    ops = collections.Counter()
    for n, s, e in tr.device:
        if s < b and e > a:
            ops[n[:160]] += (e - s) / 1e6
    gaps, last = [], a
    for s, e in tr.intervals():
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if b > last:
        gaps.append((last, b))
    labels = _innermost(tr.host, [(s + e) / 2 for s, e in gaps])
    idle = collections.Counter()
    for (s, e), label in zip(gaps, labels):
        idle[f"host: {label or 'no operation'}"[:160]] += (e - s) / 1e6
    return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}

