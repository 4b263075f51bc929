"""d2h_gbps.count: the result's download rate, GB/s: the program's
counter ``download_bytes`` over the host time of its span
``kmers.download`` (device to numpy, the pageable copy included)."""

from kmer_bench.spans import counter, host_ms


def read(tr):
    ms, nbytes = host_ms(tr, "kmers.download"), counter(tr, "download_bytes")
    if not ms or nbytes is None:
        return None
    return nbytes / (ms / 1e3) / 1e9
