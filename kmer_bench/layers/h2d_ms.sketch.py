"""h2d_ms.sketch: device ms per call of the copies from the host to the
card (the genome's upload)."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    return "HtoD" in name


def read(tr):
    return group_ms(tr, claims)
