"""wait_ms.mm: host ms per call in the blocking host reads of the
minimizer path's chunk walk (each chunk's compaction and the call's read
of the byte-class counts), from the program's span ``kmers.wait``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.wait")
