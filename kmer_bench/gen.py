"""The traffic generator: one general generator for every traffic mix.

A mix is a JSON file under ``kmer_bench/traffic/``; its ``input`` key picks
the kind of input and the other keys are its parameters.  Everything is
drawn from ``--seed``, and every seed gets the same sizes: the seed changes
the content and the order, never the amount of work.

- ``chromosome``: one synthetic chromosome (uniform ACGT, soft-masked
  stretches, N blocks, IUPAC codes, mutated copies of a repeat and a
  low-complexity region).  A frozen copy of the generator of the port's
  smoke script, with its constants as parameters.
- ``reads``: reads of fixed length sampled from a synthetic genome, half of
  them reverse-complemented, with substitutions, written to one FASTQ.
- ``genomes``: a pool of synthetic genomes of fixed lengths, one record of
  uniform ACGT each, in an order drawn from the seed.

Before each timed call the harness changes one base of the call's input
(:meth:`Inputs.mutate`), restoring the base it changed before, so that no
two calls in a row see the same bytes and no answer can be reused.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator for one purpose (``salt``) of one seed; any integer seed."""
    return np.random.default_rng([seed % 2**64, *salt])


def synth_chromosome(t: dict, rng: np.random.Generator) -> np.ndarray:
    """ASCII bases: a uniform ACGT background, soft-masked (lowercase)
    stretches, N blocks (one large one at the middle), scattered IUPAC
    codes, mutated copies of one repeat unit, and a poly-A + tandem-repeat
    region at a third of the length.  The first 100 kb holds one of each
    kind."""
    L = t["bases"]
    seq = ACGT[rng.integers(0, 4, L, dtype=np.uint8)]
    r = t["repeat_len"]
    unit = ACGT[rng.integers(0, 4, r)]
    for pos in [20_000, *rng.integers(0, L - r, t["repeat_copies"] - 1)]:
        copy = unit.copy()
        mut = rng.random(r) < t["repeat_mutation"]
        copy[mut] = ACGT[rng.integers(0, 4, mut.sum())]
        seq[pos : pos + r] = copy
    tr, half = L // 3, t["low_complexity"] // 2
    seq[tr : tr + half] = ord("A")
    seq[tr + half : tr + 2 * half] = np.resize(np.frombuffer(b"CAGGT", np.uint8), half)
    lo, hi = t["soft_mask_len"]
    for a, n in [(30_000, 5_000), *zip(rng.integers(0, L - hi, t["soft_masks"]), rng.integers(lo, hi, t["soft_masks"]))]:
        seq[a : a + n] |= 0x20
    lo, hi = t["n_block_len"]
    for a, n in [(60_000, 2_000), (L // 2, t["big_n_block"]),
                 *zip(rng.integers(0, L - hi, t["n_blocks"]), rng.integers(lo, hi, t["n_blocks"]))]:
        seq[a : a + n] = ord("N")
    iupac = np.frombuffer(b"RYKMSWryn", np.uint8)
    where = np.concatenate([[70_000, 70_005], rng.integers(0, L, t["iupac_codes"])])
    seq[where] = iupac[rng.integers(0, len(iupac), where.size)]
    return seq


_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in (b"AT", b"TA", b"CG", b"GC", b"at", b"ta", b"cg", b"gc"):
    _COMP[_a] = _b


def sample_reads(genome: np.ndarray, t: dict, rng: np.random.Generator) -> np.ndarray:
    """``(n, length)`` reads at uniform positions of ``genome``, each
    reverse-complemented with probability one half, then each base
    substituted by another with probability ``substitution_rate``."""
    n, length = t["reads"], t["read_len"]
    starts = rng.integers(0, genome.size - length + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, length)[starts]
    rc = rng.random(n) < 0.5
    reads[rc] = _COMP[reads[rc][:, ::-1]]
    sub = rng.random(reads.shape) < t["substitution_rate"]
    codes = ((reads[sub] >> 1) ^ (reads[sub] >> 2)) & 3
    reads[sub] = ACGT[(codes + rng.integers(1, 4, codes.size, dtype=np.uint8)) & 3]
    return reads


#: bytes of one FASTQ record before its bases ("@r%08d\n")
FASTQ_HEAD = 11


def write_fastq(path: Path, reads: np.ndarray) -> None:
    """One 4-line FASTQ record a read (fixed-width headers, quality 'I')."""
    n, length = reads.shape
    head = np.frombuffer(b"".join(b"@r%08d\n" % i for i in range(n)), np.uint8).reshape(n, FASTQ_HEAD)
    rows = np.concatenate([head, reads, np.full((n, 1), ord("\n"), np.uint8),
                           np.frombuffer(b"+\n", np.uint8)[None].repeat(n, 0),
                           np.full((n, length), ord("I"), np.uint8),
                           np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    path.write_bytes(rows.tobytes())


def join_with_n(reads: np.ndarray) -> np.ndarray:
    """Records joined by single 'N' bytes, so that no window spans two."""
    n, length = reads.shape
    out = np.full((n, length + 1), ord("N"), np.uint8)
    out[:, :length] = reads
    return out.reshape(-1)[:-1] if n else out.reshape(-1)


@dataclasses.dataclass
class Mutation:
    """One base of item ``item`` set to ``new`` (it was ``old``) at
    ``pos``, a position of the item's sequence as the reference sees it."""

    item: int
    pos: int
    old: int
    new: int


class Inputs:
    """A traffic mix's inputs for one seed.

    ``items`` are the sequences the calls take in turn; call ``i`` takes
    ``items[i % len(items)]`` in its current state.  :meth:`mutate` sets
    call ``i``'s one changed base; :meth:`restore` puts every item back.
    """

    def __init__(self, traffic: dict, seed: int, workdir: Path | None = None):
        self.traffic = traffic
        self.kind = traffic["input"]
        self.path = None
        if self.kind == "chromosome":
            self.items = [synth_chromosome(traffic, rng_for(seed, 1))]
        elif self.kind == "genomes":
            lengths = np.asarray(traffic["lengths"], np.int64)
            rng = rng_for(seed, 1)
            self.items = [ACGT[rng.integers(0, 4, int(n), dtype=np.uint8)] for n in rng.permutation(lengths)]
        elif self.kind == "reads":
            rng = rng_for(seed, 1)
            genome = ACGT[rng.integers(0, 4, traffic["genome_bases"], dtype=np.uint8)]
            self.reads = sample_reads(genome, traffic, rng)
            self.path = Path(workdir) / "reads.fq"
            write_fastq(self.path, self.reads)
            self.items = [self.reads]
        else:
            raise ValueError(f"unknown traffic input {self.kind!r}")
        self._mut_rng = rng_for(seed, 2)
        self._live: dict[int, Mutation] = {}

    def item_of(self, i: int) -> int:
        return i % len(self.items)

    def sequence(self, item: int) -> np.ndarray:
        """The item's sequence as the reference sees it (reads joined by
        N), in its current state."""
        if self.kind == "reads":
            return join_with_n(self.reads)
        return self.items[item]

    def _set(self, item: int, pos: int, byte: int) -> None:
        if self.kind == "reads":
            length = self.reads.shape[1]
            r, j = divmod(pos, length + 1)
            self.reads[r, j] = byte
            with open(self.path, "r+b") as f:
                f.seek(r * (FASTQ_HEAD + 2 * length + 4) + FASTQ_HEAD + j)
                f.write(bytes([byte]))
        else:
            self.items[item][pos] = byte

    def _base_positions(self, item: int) -> int:
        if self.kind == "reads":
            return self.reads.shape[0] * self.reads.shape[1]
        return self.items[item].size

    def mutate(self, i: int) -> Mutation:
        """Set call ``i``'s changed base (after restoring the one this item
        had): a position drawn from the seed, a base drawn from ACGT other
        than the one there."""
        item = self.item_of(i)
        prev = self._live.pop(item, None)
        if prev is not None:
            self._set(item, prev.pos, prev.old)
        p = int(self._mut_rng.integers(0, self._base_positions(item)))
        if self.kind == "reads":
            length = self.reads.shape[1]
            p = p // length * (length + 1) + p % length
        old = int(self.sequence_byte(item, p))
        upper = old & 0xDF
        choices = [b for b in b"ACGT" if b != upper]
        new = choices[int(self._mut_rng.integers(0, 3))]
        self._set(item, p, new)
        m = Mutation(item, p, old, new)
        self._live[item] = m
        return m

    def sequence_byte(self, item: int, pos: int) -> int:
        if self.kind == "reads":
            length = self.reads.shape[1]
            r, j = divmod(pos, length + 1)
            return int(self.reads[r, j])
        return int(self.items[item][pos])

    def restore(self) -> None:
        """Undo the live changes: every item back to its generated state."""
        for item, m in self._live.items():
            self._set(item, m.pos, m.old)
        self._live.clear()

    def close(self) -> None:
        if self.path is not None and self.path.exists():
            os.unlink(self.path)
