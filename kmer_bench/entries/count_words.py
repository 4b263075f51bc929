"""Entry ``count_words``: ``canonical_count_words`` on one host buffer,
returning the packed ``(words, counts)`` table of 32 <= K <= 62: ``(n, 2)``
``np.uint64`` rows of 62-bit words, word 0 the most significant, in
register order, and ``np.int64`` counts (the binary form KMC's and
Jellyfish's databases keep).

Its check is :func:`tables`: every answer against the word reference
(``kmer_bench/reference/words.py``), with the call's changed base applied
as ``checks.tables`` applies it, compared row by row, a row being (word 0,
word 1, count)."""

from __future__ import annotations

import numpy as np

from kmer_bench.reference import words as ref


class Entry:
    keep_all = False

    def __init__(self, ctx):
        from kmers_tpu_torch import CountConfig, canonical_count_words

        cfg = ctx.config
        self.ctx, self.fn = ctx, canonical_count_words
        self.cc = CountConfig(K=cfg["K"], skip_ambiguous=cfg["skip_ambiguous"], chunk_size=cfg["chunk_size"])
        self.seq = ctx.inputs.items[0]

    def warm(self) -> None:
        self.call(-1, None)

    def call(self, i: int, spans):
        return self.fn(self.seq, self.cc, device=self.ctx.device)

    def work(self, i: int) -> dict:
        return {"bases": self.seq.size, "k3_positions": self.seq.size}

    def check(self, kept: dict) -> list:
        return tables(self.ctx.inputs, self.ctx.config["K"], kept)

    def control(self, i: int):
        cfg = self.ctx.config
        rows, counts = ref.count_table_seam_double(self.seq, cfg["K"], cfg["chunk_size"])
        return packed(rows), counts.numpy()


def packed(rows) -> np.ndarray:
    """The reference's ``(n, 2)`` int64 rows as the program's packed words
    (both halves are non-negative, so the bits are the uint64 values)."""
    return rows.numpy().view(np.uint64)


def _delta(seq: np.ndarray, m, k: int):
    """The canonical rows of the windows over ``m.pos`` before and after
    its base changed."""
    lo = max(m.pos - k + 1, 0)
    before = seq[lo : m.pos + k].copy()
    after = before.copy()
    after[m.pos - lo] = m.new
    return ref.window_rows(before, m.pos - lo, k), ref.window_rows(after, m.pos - lo, k)


def rows_wrong(words, counts, want_w: np.ndarray, want_c: np.ndarray) -> int:
    """Rows of the answer that are not rows of the expected table, plus
    rows of the expected table missing from the answer (a repeated row
    counts as wrong); a row is (word 0, word 1, count)."""
    words = np.asarray(words)
    counts = np.asarray(counts)
    if (words.dtype != np.uint64 or words.ndim != 2 or words.shape[1:] != want_w.shape[1:]
            or counts.ndim != 1 or words.shape[0] != counts.shape[0]):
        return int(counts.size + want_c.size)
    if words.shape == want_w.shape and np.array_equal(words, want_w) and np.array_equal(counts, want_c):
        return 0
    n = words.shape[0]
    # one int64 key a row, in row order: each word's rank over both tables
    both = np.concatenate([words, want_w])
    r0 = np.unique(both[:, 0], return_inverse=True)[1].reshape(-1).astype(np.int64)
    r1 = np.unique(both[:, 1], return_inverse=True)[1].reshape(-1).astype(np.int64)
    key = (r0 << 32) | r1
    got, want = key[:n], key[n:]
    idx = np.searchsorted(want, got)
    at = np.minimum(idx, max(want.size - 1, 0))
    ok = (idx < want.size) & (want[at] == got) & (want_c[at] == counts) if want.size else idx < 0
    matched = np.unique(idx[ok]).size
    return int(n - matched + want.size - matched)


def tables(inputs, k: int, kept: dict) -> list:
    """Word tables: ``[("rows_wrong", worst answer's wrong rows, 0)]``."""
    inputs.restore()
    seq = inputs.sequence(0)
    base_r, base_c = ref.count_table(seq, k)
    worst = 0
    for m, (words, counts) in kept.values():
        minus, plus = _delta(seq, m, k)
        want_r, want_c = ref.apply_delta(base_r, base_c, minus, plus)
        worst = max(worst, rows_wrong(words, counts, packed(want_r), want_c.numpy()))
    return [("rows_wrong", worst, 0)]
