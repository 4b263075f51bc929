"""fold_ms.words: device ms per call of the word fold's kernels that are
not sorts: kernel K10 (``compact_*``: the merges' compaction and each chunk
table's front-packing) and the weighted RLE's ``searchsorted``.  Word
tables merge by re-sorting, so the fold's sorts are in ``sort_ms.words``."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    return ("compact_" in name and "_kernel" in name) or "searchsorted" in name


def read(tr):
    return group_ms(tr, claims)
