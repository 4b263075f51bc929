"""exchange_pad.count: rows a rank's exchange merge sorts (``n_dev x cap``)
over the real rows among them, from the program's counters
``exchange_rows`` and ``exchange_rows_real`` inside its span
``kmers.exchange``."""

from kmer_bench.spans import counter, host_ms


def read(tr):
    if host_ms(tr, "kmers.exchange") is None:
        return None
    rows, real = counter(tr, "exchange_rows"), counter(tr, "exchange_rows_real")
    if not rows or not real:
        return None
    return rows / real
