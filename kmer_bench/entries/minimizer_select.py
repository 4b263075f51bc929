"""Entry ``minimizer_select``: ``minimizer_select`` on one host buffer,
returning the (W, K)-minimizer sampling of the whole sequence as numpy
``(values np.uint64, positions np.int64)`` (minimap2's index of a
reference, ``minimap2 -x map-ont -d``, one chromosome a call).

Its check is :func:`sampling`: the plain reference's per-window picks of
the unchanged chromosome (``kmer_bench/reference/minimizers.py``), computed
once; for each kept answer the picks of the windows over the call's
changed base (windows ``p - K - W + 2 .. p``) recomputed on the changed
slice and spliced in, consecutive repeats dropped, and the rows of the
symmetric difference between the answer's ``(position, value)`` rows and
the reference's counted."""

from __future__ import annotations

import numpy as np

from kmer_bench import checks
from kmer_bench.reference import minimizers as ref


class Entry:
    keep_all = False

    def __init__(self, ctx):
        from kmers_tpu_torch import minimizer_select

        cfg = ctx.config
        self.ctx, self.fn = ctx, minimizer_select
        self.kw = {"K": cfg["K"], "W": cfg["W"], "canonical": cfg["canonical"],
                   "skip_ambiguous": cfg["skip_ambiguous"]}
        self.seq = ctx.inputs.items[0]

    def warm(self) -> None:
        self.call(-1, None)

    def call(self, i: int, spans):
        return self.fn(self.seq, device=self.ctx.device, **self.kw)

    def work(self, i: int) -> dict:
        return {"bases": self.seq.size, "k6_positions": self.seq.size}

    def check(self, kept: dict) -> list:
        cfg = self.ctx.config
        return sampling(self.ctx.inputs, cfg["K"], cfg["W"], cfg["canonical"], kept)

    def control(self, i: int):
        cfg = self.ctx.config
        return ref.minimizers(self.seq, cfg["K"], cfg["W"], cfg["canonical"], rightmost=True)


def rows_wrong(values, positions, want_v: np.ndarray, want_p: np.ndarray) -> int:
    """Rows ``(position, value)`` of the answer that are not rows of the
    expected sampling, plus expected rows missing from the answer (a
    repeated row counts as wrong): :func:`checks.rows_wrong` keyed by
    position (non-negative, so its unsigned view keeps the order)."""
    values, positions = np.asarray(values), np.asarray(positions)
    if values.dtype != np.uint64 or positions.dtype != np.int64:
        return int(positions.size + want_p.size)
    return checks.rows_wrong(positions.view(np.uint64), values, want_p.view(np.uint64), want_v)


def sampling(inputs, k: int, w: int, canonical: bool, kept: dict) -> list:
    """Minimizer samplings: ``[("minimizers_wrong", worst answer's wrong
    rows, 0)]``."""
    inputs.restore()
    seq = inputs.sequence(0)
    base_v, base_p = ref.window_picks(seq, k, w, canonical)
    n = base_p.size
    worst = 0
    for m, (values, positions) in kept.values():
        a, b = max(m.pos - k - w + 2, 0), min(m.pos + 1, n)
        piece = seq[a : b + w + k - 2].copy()
        piece[m.pos - a] = m.new
        new_v, new_p = ref.window_picks(piece, k, w, canonical)
        want_v, want_p = base_v.copy(), base_p.copy()
        want_v[a:b], want_p[a:b] = new_v, np.where(new_p >= 0, new_p + a, -1)
        worst = max(worst, rows_wrong(values, positions, *ref.dedup(want_v, want_p)))
    return [("minimizers_wrong", worst, 0)]
