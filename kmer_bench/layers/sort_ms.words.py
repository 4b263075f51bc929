"""sort_ms.words: device ms per call of ``torch.sort``'s kernels (radix
sort) and kernel K2 (``rle_unit_kernel``) in a word count: the two stable
passes of every chunk's lexicographic sort and of every merge's re-sort of
the fold, and K2 over each chunk's run ids."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    low = name.lower()
    return "rle_unit_kernel" in name or (
        ("sort" in low or "radix" in low) and "searchsorted" not in low and "k11_" not in low)


def read(tr):
    return group_ms(tr, claims)
