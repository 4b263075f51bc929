"""sort_ms.aa: device ms per call of ``torch.sort``'s kernels (radix sort)
and kernel K2 (``rle_unit_kernel``) in a six-frame count: each chunk's sort
of its two windows an anchor."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    low = name.lower()
    return "rle_unit_kernel" in name or (
        ("sort" in low or "radix" in low) and "searchsorted" not in low and "k11_" not in low)


def read(tr):
    return group_ms(tr, claims)
