"""resort_rows.words: rows the lexicographic word sort orders per base
counted, from the program's counter ``mw_sort_rows`` (every chunk's sort
and every merge's re-sort) over the traced calls' bases: the word fold's
sort amplification.  None where the program keeps no such counter."""

from kmer_bench.spans import counter


def read(tr):
    rows, bases = counter(tr, "mw_sort_rows"), tr.work.get("bases")
    if rows is None or not bases:
        return None
    return rows / (bases / tr.n_calls)
