"""self_ms.sketch: host ms per call in the root span of each traced call
(``kmers.*``, the outermost inside ``kb.call``) outside every
``kmers.*`` span nested in it: the host work the program's spans do not
divide (``kmer_bench/self_time.py``)."""

from kmer_bench.self_time import self_ms


def read(tr):
    return self_ms(tr)
