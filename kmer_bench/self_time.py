"""Self time of the program's root spans in a traced run.

A call's root is the outermost ``kmers.*`` span inside the harness's
``kb.call``; its self time is its length minus the part of it that the
``kmers.*`` spans nested in it cover (their union, so a span inside
another counts once), both clipped to the traced window.  That is host
time the program's spans do not divide: Python between its layers, and
work no span names yet.  It reads only the ``host`` events and ``calls``
of :class:`~kmer_bench.trace.Trace`.
"""

from __future__ import annotations

PREFIX = "kmers."


def _covered(spans: list) -> float:
    """The length of the union of ``(start, end)`` intervals sorted by start."""
    total, last = 0.0, None
    for s, e in spans:
        if last is None or s > last:
            total += e - s
            last = e
        elif e > last:
            total += e - last
            last = e
    return total


def self_ms(tr) -> float | None:
    """Summed self time of the traced calls' root spans, ms per traced
    call; None when no ``kmers.*`` span lies in the window."""
    if not tr.calls:
        return None
    a, b = tr.window
    # by start, the longer first: a root before a child that opens with it
    spans = sorted(((max(s, a), min(e, b)) for n, s, e in tr.host if n.startswith(PREFIX) and s < b and e > a),
                   key=lambda x: (x[0], -x[1]))
    if not spans:
        return None
    total, i = 0.0, 0
    while i < len(spans):
        rs, re_ = spans[i]
        i += 1
        inner = []
        while i < len(spans) and spans[i][0] < re_:
            inner.append((spans[i][0], min(spans[i][1], re_)))
            i += 1
        total += (re_ - rs) - _covered(inner)
    return total / 1e3 / tr.n_calls
