"""minimum_rows.mm: rows the sliding minimum writes a window, from the
program's counters ``minimum_rows`` (the rows each combine of the doubling
sliding minimum writes) over ``minimizer_windows`` (the windows of W
k-mers evaluated): 4 at W = 10 (three doubling rounds and the final
combine).  None where the program keeps no such counter."""

from kmer_bench.spans import counter


def read(tr):
    rows, windows = counter(tr, "minimum_rows"), counter(tr, "minimizer_windows")
    if rows is None or not windows:
        return None
    return rows / windows
