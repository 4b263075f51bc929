"""select_ms.sketch: device ms per call of the selection of the smallest
distinct hashes (``torch.topk``, ``torch.unique``, the sentinel filter
and the boundary's maximum): every device operation of the call other
than kernel K1 and the copies."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    return "canonical_windows_kernel" not in name and not name.startswith(("Memcpy", "Memset"))


def read(tr):
    return group_ms(tr, claims)
