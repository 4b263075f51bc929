"""join_ms.reads: host ms per job in the N-join of each batch's records
(``join_records_with_n``), from the program's span ``kmers.join``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.join")
