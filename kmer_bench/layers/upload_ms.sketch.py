"""upload_ms.sketch: host ms per call in the upload of the genome (host
array to device tensor, pageable staging included), from the program's
span ``kmers.upload``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.upload")
