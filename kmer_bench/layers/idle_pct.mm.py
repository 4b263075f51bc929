"""idle_pct.mm: the share of the traced calls' wall time in which the card
ran no kernel and no copy, in a minimizer sampling."""

from kmer_bench.trace import idle_pct


def read(tr):
    return idle_pct(tr)
