"""k6_roofline.mm: kernel K6 (``general_windows_kernel``, the 2-bit
canonical registers of the minimizer path) against its bound: 10 bytes a
position (a code byte and a flag byte read, an 8-byte register written) at
the card's peak bandwidth, over K6's device time."""

from kmer_bench.trace import roofline_pct

BYTES_PER_POSITION = 10


def claims(name: str) -> bool:
    return "general_windows_kernel" in name


def read(tr):
    return roofline_pct(tr, claims, BYTES_PER_POSITION, "k6_positions")
