"""wait_ms.count: host ms per call in the blocking host reads of the chunk
loop (the drain queue's) and of the fold (each merge's distinct count),
and on four cards of the mesh's reductions, from the program's span
``kmers.wait``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.wait")
