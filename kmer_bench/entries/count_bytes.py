"""Entry ``count_bytes``: ``canonical_count_bytes`` on one host buffer,
returning the numpy ``(kmers, counts)`` table (Jellyfish's ``count``)."""

from __future__ import annotations

from kmer_bench import checks
from kmer_bench.reference import kmers as ref


class Entry:
    keep_all = False

    def __init__(self, ctx):
        from kmers_tpu_torch import CountConfig, canonical_count_bytes

        cfg = ctx.config
        self.ctx, self.fn = ctx, canonical_count_bytes
        self.cc = CountConfig(K=cfg["K"], skip_ambiguous=cfg["skip_ambiguous"], chunk_size=cfg["chunk_size"])
        self.seq = ctx.inputs.items[0]

    def warm(self) -> None:
        self.call(-1, None)

    def call(self, i: int, spans):
        return self.fn(self.seq, self.cc, device=self.ctx.device)

    def work(self, i: int) -> dict:
        return {"bases": self.seq.size, "k1_positions": self.seq.size}

    def check(self, kept: dict) -> list:
        return checks.tables(self.ctx.inputs, self.ctx.config["K"], kept)

    def control(self, i: int):
        cfg = self.ctx.config
        return ref.count_table_seam_double(self.seq, cfg["K"], cfg["chunk_size"])
