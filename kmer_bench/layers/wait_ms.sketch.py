"""wait_ms.sketch: host ms per call in the sketch's blocking host reads
(the byte counters, the largest selected key), from the program's span
``kmers.wait``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.wait")
