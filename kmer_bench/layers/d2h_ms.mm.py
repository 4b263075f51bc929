"""d2h_ms.mm: device ms per call of the copies from the card to the host
(the sampling's download: values and positions)."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    return "DtoH" in name


def read(tr):
    return group_ms(tr, claims)
