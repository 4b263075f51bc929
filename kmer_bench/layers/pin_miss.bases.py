"""pin_miss.bases: the share (%) of the pinned bytes the program asked
for that torch's caching host allocator had to pin anew over the traced
calls, from the program's counters ``pinned_new_bytes`` over
``pinned_bytes``.  A new block is pinned at the next power of two, so a
window of misses alone can read above the bytes asked for; a window that
the cache serves reads 0.  None where the program keeps no such counter or
asked for no pinned bytes."""

from kmer_bench.spans import counter


def read(tr):
    asked, new = counter(tr, "pinned_bytes"), counter(tr, "pinned_new_bytes")
    if not asked or new is None:
        return None
    return 100.0 * new / asked
