"""k4_roofline.aa: kernel K4 (``sixframe_kernel<1>``, one 56-bit key a
window of K <= 7 amino acids) against its bound: 17 bytes an anchor (one
byte read, the forward and the reverse window's 8-byte keys written) at the
card's peak bandwidth, over K4's device time."""

from kmer_bench.trace import roofline_pct

BYTES_PER_ANCHOR = 17


def claims(name: str) -> bool:
    return "sixframe_kernel<1>" in name


def read(tr):
    return roofline_pct(tr, claims, BYTES_PER_ANCHOR, "k4_positions")
