"""Entry ``sharded_count``: ``sharded_canonical_count`` of one host buffer
over the mesh of every rank (one rank a process and a card), each rank
returning the whole numpy ``(kmers, counts)`` table."""

from __future__ import annotations

from kmer_bench import checks
from kmer_bench.reference import kmers as ref


class Entry:
    keep_all = False

    def __init__(self, ctx):
        from kmers_tpu_torch import parallel as par

        cfg = ctx.config
        self.ctx, self.fn = ctx, par.sharded_canonical_count
        self.mesh = ctx.mesh if ctx.mesh is not None else par.data_mesh(device=ctx.device)
        self.cc = par.ShardedCountConfig(K=cfg["K"], bucket_factor=cfg["bucket_factor"],
                                         chunk_size=cfg["chunk_size"])
        self.seq = ctx.inputs.items[0]
        # the bytes this process's first rank counts: its slab and halo
        self.slab = -(-self.seq.size // self.mesh.size) + cfg["K"] - 1

    def warm(self) -> None:
        self.call(-1, None)

    def call(self, i: int, spans):
        return self.fn(self.seq, self.cc, self.mesh)

    def work(self, i: int) -> dict:
        return {"bases": self.seq.size, "k1_positions": self.slab * len(self.mesh.devices)}

    def check(self, kept: dict) -> list:
        return checks.tables(self.ctx.inputs, self.ctx.config["K"], kept)

    def control(self, i: int):
        cfg = self.ctx.config
        return ref.count_table_seam_double(self.seq, cfg["K"], cfg["chunk_size"])
