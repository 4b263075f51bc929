"""Entry ``sixframe_count``: ``sixframe_aa_count`` on one host buffer,
returning the numpy ``(kmers, counts)`` table of the amino-acid K-mers of
all six reading frames (K <= 7: ``np.uint64`` keys, 8 bits an amino acid,
the earliest codon highest; ``np.int64`` counts), the table MMseqs2's
translated prefilter indexes.

Its check is :func:`tables`: every answer against the six-frame reference
(``kmer_bench/reference/sixframe.py``), with the call's changed base
applied: the windows over it (anchors ``p - 3K + 1 .. p`` on both strands)
before the change taken away and those after it added, compared row by
row."""

from __future__ import annotations

import numpy as np

from kmer_bench import checks
from kmer_bench.reference import kmers as nucleotide
from kmer_bench.reference import sixframe as ref


class Entry:
    keep_all = False

    def __init__(self, ctx):
        from kmers_tpu_torch import SixFrameCountConfig, ncbi_trans_table, sixframe_aa_count

        cfg = ctx.config
        self.ctx, self.fn = ctx, sixframe_aa_count
        if cfg["code"] != 1:
            raise ValueError(f"the six-frame reference translates with NCBI table 1 only (got {cfg['code']})")
        self.sc = SixFrameCountConfig(K=cfg["K"], chunk_size=cfg["chunk_size"], code=ncbi_trans_table[1])
        self.seq = ctx.inputs.items[0]

    def warm(self) -> None:
        self.call(-1, None)

    def call(self, i: int, spans):
        return self.fn(self.seq, self.sc, device=self.ctx.device)

    def work(self, i: int) -> dict:
        return {"bases": self.seq.size, "k4_positions": self.seq.size}

    def check(self, kept: dict) -> list:
        return tables(self.ctx.inputs, self.ctx.config["K"], kept)

    def control(self, i: int):
        cfg = self.ctx.config
        kmers, counts = ref.count_table(self.seq, cfg["K"])
        plus = ref.seam_keys(self.seq, cfg["K"], cfg["chunk_size"])
        return nucleotide.apply_delta(kmers, counts, np.zeros(0, np.uint64), plus)


def _delta(seq, m, k: int):
    """The keys of the windows over ``m.pos`` before and after its base
    changed."""
    lo = max(m.pos - 3 * k + 1, 0)
    before = seq[lo : m.pos + 3 * k].copy()
    after = before.copy()
    after[m.pos - lo] = m.new
    return ref.window_keys(before, m.pos - lo, k), ref.window_keys(after, m.pos - lo, k)


def tables(inputs, k: int, kept: dict) -> list:
    """Six-frame tables: ``[("rows_wrong", worst answer's wrong rows, 0)]``."""
    inputs.restore()
    seq = inputs.sequence(0)
    base_k, base_c = ref.count_table(seq, k)
    worst = 0
    for m, (kmers, counts) in kept.values():
        minus, plus = _delta(seq, m, k)
        want_k, want_c = nucleotide.apply_delta(base_k, base_c, minus, plus)
        worst = max(worst, checks.rows_wrong(kmers, counts, want_k, want_c))
    return [("rows_wrong", worst, 0)]
