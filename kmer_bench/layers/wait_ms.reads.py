"""wait_ms.reads: host ms per job in the blocking host reads of the chunk
loop (the drain queue's) and of the fold (each merge's distinct count),
from the program's span ``kmers.wait``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.wait")
