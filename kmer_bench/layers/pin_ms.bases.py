"""pin_ms.bases: host ms per call in the program's pinned host
allocations (``cudaHostAlloc`` when torch's caching host allocator grows
included), from its span ``kmers.pin``."""

from kmer_bench.spans import host_ms


def read(tr):
    return host_ms(tr, "kmers.pin")
