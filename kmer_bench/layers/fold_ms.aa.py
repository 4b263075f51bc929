"""fold_ms.aa: device ms per call of the six-frame table fold: kernel K9
(``k9_*``), kernel K10 (``compact_*``: the merges' compaction and each
chunk table's front-packing) and the weighted RLE's ``searchsorted``."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    return "k9_" in name or ("compact_" in name and "_kernel" in name) or "searchsorted" in name


def read(tr):
    return group_ms(tr, claims)
