"""read_ms.reads: host ms per job in the file read of each batch of
``stream_fastx`` (``readinto`` of the batch's block into the reused buffer,
its growth included, inside the parse), from the program's span
``kmers.read``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.read")
