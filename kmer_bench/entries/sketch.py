"""Entry ``sketch``: ``minhash_sketch`` of the next genome of the pool,
round robin, returning its numpy sketch (Mash's ``sketch``)."""

from __future__ import annotations

from kmer_bench import checks
from kmer_bench.reference import kmers as ref


class Entry:
    keep_all = True

    def __init__(self, ctx):
        from kmers_tpu_torch import minhash_sketch

        self.ctx, self.fn = ctx, minhash_sketch
        self.items = ctx.inputs.items

    def _item(self, i: int):
        return self.items[self.ctx.inputs.item_of(i)]

    def warm(self) -> None:
        for i in range(len(self.items)):
            self.call(i, None)

    def call(self, i: int, spans):
        cfg = self.ctx.config
        return self.fn(self._item(i), K=cfg["K"], s=cfg["s"], skip_ambiguous=cfg["skip_ambiguous"],
                       device=self.ctx.device)

    def work(self, i: int) -> dict:
        n = self._item(i).size
        return {"sketches": 1, "bases": n, "k1_positions": n}

    def check(self, kept: dict) -> list:
        cfg = self.ctx.config
        return checks.sketches(self.ctx.inputs, cfg["K"], cfg["s"], kept, self.ctx.seed)

    def control(self, i: int):
        cfg = self.ctx.config
        return ref.sketch_hash32(self._item(i), cfg["K"], cfg["s"])
