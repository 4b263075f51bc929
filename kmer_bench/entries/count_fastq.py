"""Entry ``count_fastq``: ``count_fastx_stream`` of one FASTQ file,
parse included, returning the numpy ``(kmers, counts)`` table.

A traced call drives ``StreamingCounter`` over ``stream_fastx`` as
``count_fastx_stream`` does, with a span (``kb.parse``) around each
batch's read and parse."""

from __future__ import annotations

import time

from kmer_bench import checks
from kmer_bench.gen import join_with_n
from kmer_bench.reference import kmers as ref

PARSE = "kb.parse"


class Entry:
    keep_all = False

    def __init__(self, ctx):
        from kmers_tpu_torch import CountConfig

        cfg = ctx.config
        self.ctx = ctx
        self.cc = CountConfig(K=cfg["K"], skip_ambiguous=cfg["skip_ambiguous"], chunk_size=cfg["chunk_size"])
        self.path = ctx.inputs.path
        self.n_reads, self.read_len = ctx.inputs.reads.shape

    def warm(self) -> None:
        from kmers_tpu_torch.io import native_available

        self.ctx.log(f"native FASTX scanner: {native_available()}")
        self.call(-1, None)

    def call(self, i: int, spans):
        from kmers_tpu_torch import StreamingCounter, count_fastx_stream
        from kmers_tpu_torch.io import stream_fastx

        batch = self.ctx.config["batch_bytes"]
        if spans is None:
            return count_fastx_stream(self.path, self.cc, batch_bytes=batch, device=self.ctx.device)
        from torch.profiler import record_function

        sc = StreamingCounter(self.cc, device=self.ctx.device)
        batches = stream_fastx(self.path, batch_bytes=batch)
        parse = spans.setdefault(PARSE, [])
        while True:
            t0 = time.perf_counter()
            with record_function(PARSE):
                records = next(batches, None)
            parse.append(time.perf_counter() - t0)
            if records is None:
                return sc.finalize()
            sc.update(*records)

    def work(self, i: int) -> dict:
        return {"reads": self.n_reads, "bases": self.n_reads * self.read_len}

    def check(self, kept: dict) -> list:
        return checks.tables(self.ctx.inputs, self.ctx.config["K"], kept)

    def control(self, i: int):
        """The seam double count of the other counting cells, over the
        reads joined by N."""
        cfg = self.ctx.config
        return ref.count_table_seam_double(join_with_n(self.ctx.inputs.reads), cfg["K"], cfg["chunk_size"])
