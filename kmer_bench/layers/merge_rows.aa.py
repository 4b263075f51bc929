"""merge_rows.aa: rows kernel K9 merges per window counted, from the
program's counters ``merge_rows`` (the rows ``merge_tables`` is given) over
``aa_windows`` (the six-frame windows counted): the fold's amplification.
None where the program keeps no such counter."""

from kmer_bench.spans import counter


def read(tr):
    rows, windows = counter(tr, "merge_rows"), counter(tr, "aa_windows")
    if rows is None or not windows:
        return None
    return rows / windows
