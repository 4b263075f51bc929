"""k1_roofline.count: kernel K1 (``canonical_windows_kernel``, register
mode) against its bound: 9 bytes a position (one byte read, one 8-byte
register written) at the card's peak bandwidth, over K1's device time."""

from kmer_bench.trace import roofline_pct

BYTES_PER_POSITION = 9


def claims(name: str) -> bool:
    return "canonical_windows_kernel" in name


def read(tr):
    return roofline_pct(tr, claims, BYTES_PER_POSITION, "k1_positions")
