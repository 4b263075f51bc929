"""select_ms.mm: device ms per call of the minimizer selection: every
device operation of the call other than kernel K6 and the copies and sets
(the encode, FxHash, the doubling sliding minimum, the dedup and the
compaction)."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    return "general_windows_kernel" not in name and not name.startswith(("Memcpy", "Memset"))


def read(tr):
    return group_ms(tr, claims)
