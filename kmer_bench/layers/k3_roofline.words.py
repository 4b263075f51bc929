"""k3_roofline.words: kernel K3 (``canonical_windows_mw_kernel``, two
words a window at 32 <= K <= 62) against its bound: 17 bytes a position
(one byte read, two 8-byte words written) at the card's peak bandwidth,
over K3's device time."""

from kmer_bench.trace import roofline_pct

BYTES_PER_POSITION = 17


def claims(name: str) -> bool:
    return "canonical_windows_mw_kernel" in name


def read(tr):
    return roofline_pct(tr, claims, BYTES_PER_POSITION, "k3_positions")
