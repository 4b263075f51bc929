"""parse_ms.reads: host ms per job in ``stream_fastx``'s read and parse of
each batch, from the harness's span around each batch (``kb.parse``)."""

from kmer_bench.trace import span_ms


def read(tr):
    return span_ms(tr, "kb.parse")
