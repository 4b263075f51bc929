"""The comparison that decides ``correct``: the program's answers against
the plain reference (``kmer_bench/reference/``), each number with its limit.

Every comparison here is exact, so every limit is 0: the configurations
state exact tables and exact sketches, and one wrong row or hash is a wrong
answer.  The reference runs after the window, from the inputs the
generator made (their changed bases undone); each answer's expected value
is the reference's table or sketch of the unchanged input with the
windows over the call's changed base taken away and those of its new base
added.
"""

from __future__ import annotations

import hashlib

import numpy as np

from kmer_bench.gen import Inputs, Mutation
from kmer_bench.reference import kmers as ref


class Keeper:
    """The answers kept for the check: every answer (``keep_all``), or the
    last one and a reservoir of ``size`` earlier ones drawn from the seed,
    so that any call of the window may be the one checked."""

    def __init__(self, seed: int, keep_all: bool, size: int = 2):
        self.keep_all, self.size = keep_all, size
        self.rng = np.random.default_rng([seed % 2**64, 3])
        self.slots: list = []
        self.seen = 0
        self.last = None
        self.all: dict = {}

    def offer(self, i: int, m: Mutation, answer) -> None:
        if self.keep_all:
            self.all[i] = (m, answer)
            return
        if self.last is not None:
            if len(self.slots) < self.size:
                self.slots.append(self.last)
            else:
                j = int(self.rng.integers(0, self.seen + 1))
                if j < self.size:
                    self.slots[j] = self.last
            self.seen += 1
        self.last = (i, m, answer)

    def kept(self) -> dict:
        """``{call index: (mutation, answer)}``."""
        if self.keep_all:
            return self.all
        rows = self.slots + ([self.last] if self.last is not None else [])
        return {i: (m, a) for i, m, a in rows}


def digest(answer) -> str:
    """A digest of an answer's arrays, to compare ranks' answers."""
    h = hashlib.blake2b(digest_size=16)
    for arr in answer:
        h.update(np.ascontiguousarray(arr).view(np.uint8))
    return h.hexdigest()


def _delta(seq: np.ndarray, m: Mutation, k: int):
    """The canonical k-mers of the windows over ``m.pos`` before and
    after its base changed."""
    lo = max(m.pos - k + 1, 0)
    before = seq[lo : m.pos + k].copy()
    after = before.copy()
    after[m.pos - lo] = m.new
    return ref.window_kmers(before, m.pos - lo, k), ref.window_kmers(after, m.pos - lo, k)


def rows_wrong(kmers, counts, want_k, want_c) -> int:
    """Rows of the answer that are not rows of the expected table, plus
    rows of the expected table missing from the answer (a repeated row
    counts as wrong)."""
    kmers = np.asarray(kmers)
    counts = np.asarray(counts)
    if kmers.shape == want_k.shape and np.array_equal(kmers, want_k) and np.array_equal(counts, want_c):
        return 0
    if kmers.dtype != np.uint64 or kmers.ndim != 1 or kmers.shape != counts.shape:
        return int(kmers.size + want_k.size)
    idx = np.searchsorted(want_k, kmers)
    at = np.minimum(idx, max(want_k.size - 1, 0))
    ok = (idx < want_k.size) & (want_k[at] == kmers) & (want_c[at] == counts) if want_k.size else idx < 0
    matched = np.unique(idx[ok]).size
    return int(kmers.size - matched + want_k.size - matched)


def tables(inputs: Inputs, k: int, kept: dict) -> list:
    """Count tables: ``[("rows_wrong", worst answer's wrong rows, 0)]``."""
    inputs.restore()
    seq = inputs.sequence(0)
    base_k, base_c = ref.count_table(seq, k)
    worst = 0
    for m, (kmers, counts) in kept.values():
        minus, plus = _delta(seq, m, k)
        want_k, want_c = ref.apply_delta(base_k, base_c, minus, plus)
        worst = max(worst, rows_wrong(kmers, counts, want_k, want_c))
    return [("rows_wrong", worst, 0)]


#: the most sketches compared in a run: a sample drawn from the seed
SKETCH_SAMPLE = 1000


def sketches(inputs: Inputs, k: int, s: int, kept: dict, seed: int) -> list:
    """Sketches: of :data:`SKETCH_SAMPLE` calls drawn from the seed (every
    call when there are fewer), how many returned a sketch other than the
    reference's, and the most hashes one of them got wrong."""
    inputs.restore()
    head = s + 2 * k + 2
    heads = {}
    n_wrong, worst = 0, 0
    calls = sorted(kept)
    if len(calls) > SKETCH_SAMPLE:
        rng = np.random.default_rng([seed % 2**64, 4])
        calls = sorted(rng.choice(calls, SKETCH_SAMPLE, replace=False).tolist())
    for m, got in (kept[i] for i in calls):
        seq = inputs.sequence(m.item)
        if m.item not in heads:
            heads[m.item] = ref.hash_table(seq, k, head=head)
        minus, plus = _delta(seq, m, k)
        want = ref.sketch_after(*heads[m.item], minus, plus, s)
        got = np.asarray(got)
        if got.shape != want.shape or not np.array_equal(got, want):
            n_wrong += 1
            extra = got.size - np.unique(got).size
            worst = max(worst, int(np.setxor1d(got, want).size) + extra)
    return [("sketches_wrong", n_wrong, 0), ("hashes_wrong", worst, 0)]
