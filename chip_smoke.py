#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``kmers_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. device: require CUDA; print the card (nvidia-smi), torch, CUDA and nvcc;
2. build: compile the kernels from ``kmers_tpu_torch/csrc`` with nvcc;
3. kernels: each kernel bit-exact against its plain torch version on the
   card at the main paths' shapes (K1 and K2 at 2^20, K3 at 2^19 and
   K = 32, 33, 47, 63, each front-end on four views; K1's hash mode on the
   same four views at K = 1, 21, 31 and on the whole chromosome; K1 in both
   modes at K = 1, 2, 15, 16, 31 and K3 at K = 32, 33, 47, 62, 63 on views
   aimed at their packed tiles (flagged bytes and N runs at the edges of
   code words and tiles, lengths TILE - 1, TILE, TILE + 1 and 2^20 - 30,
   offsets 1-15 and 17), with the device time per launch of K1's register
   mode at 2^20 bytes (K = 15 and 31) and at ``bench``'s 2^26 bytes, of its
   hash mode on the chromosome at K = 21 and of K3 at 2^19 bytes (K = 47
   and 63), each beside its bound, and ptxas's registers and spills of
   every kernel in phase 2; K6 at its
   five (bps, K, canonical) cases on 2^20 symbols at an odd offset and on
   the whole chromosome; K4 at K = 1, 5, 7 and K5 at K = 8, 15, 32 on four
   views with the strands clipped differently, and K4 and K5 at
   K = 1, 2, 7, 8, 10, 15, 23, 31, 32 on views aimed at their frame-major
   tiles (flagged bytes and N runs at code-word, tile and halo edges, bounds
   outside the input, lengths 3K - 1 to 2^20 - 30, offsets 1-15 and 17) in
   the standard code and NCBI table 2, with their device time per launch at
   2^20 bytes (K = 1, 7, 8, 15, 32) beside the bound; K9 at edge cases aimed at
   its tile partition (runs of equal keys across tiles, an empty table,
   disjoint key ranges, a single row, lengths off the tile, tables off a
   16-byte boundary), at a chunk-table shape and at the K = 31 fold's
   last-merge shape; K10 on K = 31, six-frame and K = 47 chunk tables), with
   kernel, plain and library times (CUDA events, median of 20) and K9/K10
   device times per launch by kernel (``torch.profiler``);
4. slice K = 31: canonical counting of a synthetic 48,129,895-base
   chromosome (the length of GRCh37 chr21) on the card, exactly equal to
   an independent numpy reference, its first 100 kb equal to a
   string-level Counter, the CLI's totals on a 3-record FASTA, the
   kernels' launch counts from the counting run (K9 once a merge, K10
   once a chunk and once a merge), the fold's stream time with K9's share
   and a ``torch.profiler`` breakdown;
   then the parallel plane (``phase_parallel``): ``sharded_canonical_count``
   at K = 31 over ``data_mesh(1)``, over 4 ranks on ``cuda:0`` (the
   streamed route, 12 slab chunks a rank) and over an NCCL process group of
   one rank built in the process and torn down after, each equal to the
   single-device table (so to the numpy reference), each rank's k-mers
   routed to it, and the launches of K1, K2, K9 and K10 equal to the slab
   and chunk geometry, with the walls, the ranks, ``cap``, the overflow and
   the exchange's device time; K1 and K2 against plain on a rank's first
   slab chunk cut to an odd length; ``sharded_canonical_count_mw`` at
   K = 47 on 4 Mb over 4 ranks and over NCCL (one K3 launch a rank) and
   ``sharded_minimizer_select`` at K = 15, W = 10 over 4 ranks (one K6
   launch a rank), each equal to the single-device result (the sharded
   six-frame runs follow phase 7);
5. slice K = 47 (multi-word registers, K3): the same chromosome, checks and
   launch counts (K10 only: word tables merge by sorting), a stage
   breakdown with synchronising timers; then a few hundred kb at K = 63 (K3,
   three words) and K = 80 (plain windows) against the numpy reference;
6. minhash + extract: on the same chromosome, ``minhash_sketch`` at K = 21,
   s = 1000 (K1's hash mode, with a ``torch.profiler`` breakdown) through
   the full-width fallback, and through the exact prefix on the chromosome
   without its poly-A/tandem region,
   ``extract_kmers`` at K = 31 and ``minimizer_select`` at K = 15, W = 10
   (K6), each equal to a numpy reference; ``sketch_fastx_stream`` over a
   40-record FASTA equal to the one-shot sketch; the CLI's ``sketch`` and
   ``dist`` on two FASTAs of 2 Mb against numpy sketches; K = 32 minhash
   and extraction (plain torch) on 300 kb against numpy;
7. six-frame: ``sixframe_aa_count`` at K = 7 on the same chromosome (K4,
   then sort and K2), exactly equal to an independent numpy reference that
   translates each strand's three frames, its first 100 kb equal to a
   string-level Counter, with launch counts (K9 and K10 at K = 7, K10 at
   K = 15), wall time, amino-acid windows per second, the fold's stream
   time and a ``torch.profiler`` breakdown; K = 15 on the first 8 Mb (K5,
   the word path) and K = 8 and 32 on 1 Mb, each equal to numpy; the CLI's
   ``sixframe`` on a 3-record FASTA equal to a string counter; then
   sharded six-frame counting (``phase_parallel_sixframe``): K4 and K5
   against plain on a rank's first and last slab chunks with the rank's
   bounds, K = 7 on the whole chromosome over ``data_mesh(1)``, over 4
   ranks on ``cuda:0`` and over an NCCL group of one rank, each equal to
   the single-device K = 7 table, and K = 12 (K5, two words) on 1 Mb over
   4 ranks and over NCCL, equal to one device and to numpy; in each run
   every rank's k-mers routed to it and the launches of K4 or K5, K2, K9
   and K10 equal to the slab and chunk geometry, with the wall, the
   amino-acid windows/s, ``cap`` and the exchange's device time; the
   CLI's ``sixframe`` on a 1 Mb FASTA equal to one device;
8. streaming, tables, bench: ``count_fastx_stream`` over a FASTQ of
   400,000 reads of 150 bp sampled from the chromosome (half of them
   reverse-complemented) in batches of 16 MiB, equal to the numpy
   reference of the records joined with N and to ``canonical_count_records``,
   with its launch counts, rates and a profile; ``merge_counts_device`` of
   the two halves' tables equal to the whole table, with K9's share of its
   time; ``python -m kmers_tpu_torch bench`` (its four-key line); the CLI's
   ``count --stream`` on a 3-record FASTQ equal to a string counter; the
   native FASTX scanner required, and the streamed call's host time split
   by stage (parse, N-join, upload, the drain of each chunk) with the native
   and with the pure-Python parse, with reads/s and the device's busy share
   of each;
9. sort: the sort-wall probe on this card, K1 -> K11 (``bitonic_sort``) ->
   K2 in place of K1 -> ``torch.sort`` -> K2, on one 2^20 chunk and on
   ``bench``'s 2^26-byte chunk, bit-equal to the default route, with both
   routes' times and K11's device time per launch;
10. checkpoints: the CLI's ``count -k 31 -o`` of the chromosome loaded back
   equal to ``canonical_count_bytes``, ``merge`` of the two halves'
   checkpoints in process (one K9 and one K10 launch) equal to the table of
   the halves as two records, ``verify`` exiting 0 and, after one changed
   byte of the input, 1; a K = 47 round trip on 300 kb.

The kernel phase also holds K11 (edge cases at one and two tiles, runs of
equal keys across merge rounds, keys off a 16-byte boundary, the local pass
and the full sort at 2^20, 2^24 and 2^26 keys, the full sort equal to
``torch.sort``; times at 2^24 with device time per launch by kernel) and
K8b at K = 32 (forward and canonical on the chromosome,
both planes) against their plain versions, and phase 6 extracts every 32-mer
of the chromosome (one K8b launch each, forward and canonical) against
numpy.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON, and the one before that the card's name and
power limit.  Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHR21_BASES = 48_129_895  # GRCh37 chr21
K = 31
CHUNK = 1 << 20
K_MW = 47
CHUNK_MW = 1 << 19
K_SKETCH = 21  # Mash's default k and s
S_SKETCH = 1000
#: K6's cases: (bps, K, canonical)
GENERAL_CASES = [(2, 31, True), (2, 16, False), (4, 15, True), (4, 9, False), (4, 8, False),
                 (8, 7, False), (8, 1, False)]
K_AA = 7  # six-frame counting: K4's widest K, the JAX package's default
K_AA_MW = 15
K_AA_WIDE = 12  # sharded six-frame on K5: two words
#: K4's and K5's K on the views aimed at their frame-major tiles
SIXFRAME_EDGE_KS = (1, 2, 7, 8, 10, 15, 23, 31, 32)
READS, READ_LEN = 400_000, 150  # the streamed read set (phase 8)
STREAM_BATCH = 1 << 24
#: NCBI transl_table 1 (amino acids of TTT, TTC, TTA, ... in T, C, A, G
#: order) and the amino-acid alphabet whose index is an amino acid's code
NCBI_STANDARD = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
AA_CHARS = "ARNDCQEGHILKMFPSTWYVOUBJZX*-"
#: H100 SXM device memory rate (NVIDIA data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
#: K11's key counts in the kernel phase (the probe sorts a 2^20 chunk and
#: bench's 2^26-byte chunk); its times are taken at SORT_TIMED
SORT_SHAPES = (1 << 20, 1 << 24, 1 << 26)
SORT_TIMED = 1 << 24
WORD_BITS = 62
#: FxHash's multiplier (a hash of a one-word register is reg * FX mod 2^64)
FX = np.uint64(0x517CC1B727220A95)
ALL_ONES = np.uint64(2**64 - 1)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------- data


def synth_chromosome(L: int, seed: int) -> np.ndarray:
    """ASCII bases: a uniform ACGT background, soft-masked (lowercase)
    stretches, N blocks (one of 150 kb), scattered IUPAC codes, 400 mutated
    copies of a 300-bp repeat, and a 100-kb poly-A + tandem-repeat region.
    The first 100 kb holds one of each kind."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L, dtype=np.uint8)]
    unit = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 300)]
    for pos in [20_000, *rng.integers(0, L - 300, 399)]:
        copy = unit.copy()
        mut = rng.random(300) < 0.03
        copy[mut] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, mut.sum())]
        seq[pos : pos + 300] = copy
    tr = L // 3
    seq[tr : tr + 50_000] = ord("A")
    seq[tr + 50_000 : tr + 100_000] = np.resize(np.frombuffer(b"CAGGT", np.uint8), 50_000)
    for a, n in [(30_000, 5_000), *zip(rng.integers(0, L - 5_000, 2_000), rng.integers(100, 5_000, 2_000))]:
        seq[a : a + n] |= 0x20  # soft mask
    for a, n in [(60_000, 2_000), (L // 2, 150_000), *zip(rng.integers(0, L - 10_000, 20), rng.integers(100, 10_000, 20))]:
        seq[a : a + n] = ord("N")
    iupac = np.frombuffer(b"RYKMSWryn", np.uint8)
    where = np.concatenate([[70_000, 70_005], rng.integers(0, L, 300)])
    seq[where] = iupac[rng.integers(0, len(iupac), where.size)]
    return seq


def numpy_reference(seq: np.ndarray, k: int):
    """Sorted distinct canonical k-mers and counts, computed with numpy
    alone, as ``(words, counts)``: ``words`` is ``(W, n)`` uint64 with
    ``W = ceil(k / 31)``, word 0 the first ``k - 31 (W - 1)`` bases of a
    k-mer and every other word the next 31 (for k <= 31, ``words[0]`` is
    the register).  Forward words are registers shifted in over their bases,
    reverse-complement words forward registers of the complemented reversed
    stream; the canonical k-mer is the lexicographic minimum over the words;
    validity comes from a cumulative sum of non-ACGTU bytes."""
    L = seq.size
    n = L - k + 1
    W = -(-k // 31)
    if n <= 0:
        return np.zeros((W, 0), np.uint64), np.zeros(0, np.int64)
    up = seq & 0xDF
    good = np.isin(up, np.frombuffer(b"ACGTU", np.uint8))
    codes = (((seq >> 1) ^ (seq >> 2)) & 3).astype(np.uint64)
    comp_rev = (np.uint64(3) - codes)[::-1].copy()

    def forward(c, width):
        m = c.size - width + 1
        reg = np.zeros(m, np.uint64)
        for j in range(width):
            np.left_shift(reg, np.uint64(2), out=reg)
            np.bitwise_or(reg, c[j : j + m], out=reg)
        return reg

    widths = [k - 31 * (W - 1)] + [31] * (W - 1)
    fwd = {w: forward(codes, w) for w in set(widths)}
    # rev[w][p]: the reverse complement of the bases [p, p + w)
    rev = {w: forward(comp_rev, w)[::-1] for w in set(widths)}
    fw, rc = [], []
    off = 0
    for w in widths:
        fw.append(fwd[w][off : off + n])
        start = k - off - w
        rc.append(rev[w][start : start + n])
        off += w
    del fwd, rev
    lt = np.zeros(n, bool)
    eq = np.ones(n, bool)
    for f, r in zip(fw, rc):
        lt |= eq & (f < r)
        eq &= f == r
    lt |= eq
    bad = np.concatenate([[0], np.cumsum(~good, dtype=np.int64)])
    valid = (bad[k:] - bad[:n]) == 0
    words = np.stack([np.where(lt, f, r)[valid] for f, r in zip(fw, rc)])
    del fw, rc
    words = words[:, np.lexsort(words[::-1])]
    m = words.shape[1]
    first = np.ones(m, bool)
    first[1:] = (words[:, 1:] != words[:, :-1]).any(0)
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, m)).astype(np.int64)
    return words[:, starts], counts


def numpy_windows(seq: np.ndarray, k: int):
    """Forward and canonical k-mer registers (k <= 32, uint64, first base
    in the highest bits) of every window of ``seq``, and the windows'
    validity, with numpy alone."""
    n = seq.size - k + 1
    up = seq & 0xDF
    good = np.isin(up, np.frombuffer(b"ACGTU", np.uint8))
    codes = (((seq >> 1) ^ (seq >> 2)) & 3).astype(np.uint64)
    fw = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    for j in range(k):
        c = codes[j : j + n]
        np.left_shift(fw, np.uint64(2), out=fw)
        np.bitwise_or(fw, c, out=fw)
        np.bitwise_or(rc, (np.uint64(3) - c) << np.uint64(2 * j), out=rc)
    bad = np.concatenate([[0], np.cumsum(~good, dtype=np.int64)])
    return fw, np.minimum(fw, rc), (bad[k:] - bad[:n]) == 0


def numpy_sketch(seq: np.ndarray, k: int, s: int) -> np.ndarray:
    """The s smallest distinct FxHashes of the canonical k-mers (k <= 32)
    of ``seq``: the valid canonical registers of :func:`numpy_windows`,
    times the FxHash constant mod 2^64, distinct and sorted."""
    _, can, valid = numpy_windows(seq, k)
    h = np.sort(can[valid] * FX)
    return h[np.concatenate([[True], h[1:] != h[:-1]])][:s]


def numpy_jaccard(a: np.ndarray, b: np.ndarray) -> float:
    """Mash's estimate: the share of the s smallest of the union that lie
    in both sketches, with s the smaller sketch's size."""
    merged = np.union1d(a, b)[: min(a.size, b.size)]
    return float(np.isin(merged, np.intersect1d(a, b)).sum()) / float(merged.size)


def join_words(words: np.ndarray) -> np.ndarray:
    """``(W, n)`` reference words -> an object array of Python ints."""
    out = words[0].astype(object)
    for w in words[1:]:
        out = (out << WORD_BITS) | w.astype(object)
    return out


def string_counter(text: str, k: int) -> dict:
    """{canonical register: count} from Python strings alone."""
    text = text.upper().replace("U", "T")
    comp = str.maketrans("ACGT", "TGCA")
    digits = str.maketrans("ACGT", "0123")
    out = collections.Counter()
    for i in range(len(text) - k + 1):
        w = text[i : i + k]
        if set(w) <= {"A", "C", "G", "T"}:
            out[int(min(w, w.translate(comp)[::-1]).translate(digits), 4)] += 1
    return dict(out)


def codon_table_from_ncbi(ncbi: str) -> np.ndarray:
    """The 64-entry codon -> amino-acid table of an NCBI string, indexed
    by ``(a << 4) | (b << 2) | c`` of the 2-bit codes (A=0, C=1, G=2, T=3)."""
    tcag = {"T": 3, "C": 1, "A": 0, "G": 2}
    tbl = np.zeros(64, np.uint8)
    for i, ch in enumerate(ncbi):
        a, b, c = "TCAG"[i >> 4], "TCAG"[(i >> 2) & 3], "TCAG"[i & 3]
        tbl[(tcag[a] << 4) | (tcag[b] << 2) | tcag[c]] = AA_CHARS.index(ch)
    return tbl


def numpy_sixframe(seq: np.ndarray, k: int, tbl: np.ndarray):
    """Sorted distinct six-frame amino-acid k-mers and counts, with numpy
    alone, as ``(limbs, counts)``: ``limbs`` is ``(ceil(k / 8), n)`` uint64,
    limb 0 the lowest 64 bits of the 8k-bit register (the earliest codon
    highest).  Each strand's three frames are translated directly: the
    forward stream, and the complemented reversed stream (the opposite
    strand read 5' to 3'); a window counts where its 3k bases are all
    certain.  Distinct values come from a sort and a neighbour test."""
    up = seq & 0xDF
    good = np.isin(up, np.frombuffer(b"ACGTU", np.uint8))
    codes = (((seq >> 1) ^ (seq >> 2)) & 3).astype(np.uint8)
    n_limbs = -(-k // 8)
    parts = [[] for _ in range(n_limbs)]
    for c, g in ((codes, good), ((3 - codes)[::-1], good[::-1])):
        for f in range(3):
            n_c = (c.size - f) // 3
            cod = c[f : f + 3 * n_c].reshape(n_c, 3).astype(np.int64)
            aa = tbl[(cod[:, 0] << 4) | (cod[:, 1] << 2) | cod[:, 2]].astype(np.uint64)
            ok = g[f : f + 3 * n_c].reshape(n_c, 3).all(1)
            m = n_c - k + 1
            if m <= 0:
                continue
            bad = np.concatenate([[0], np.cumsum(~ok, dtype=np.int64)])
            valid = (bad[k:] - bad[:m]) == 0
            limbs = [np.zeros(m, np.uint64) for _ in range(n_limbs)]
            for i in range(k):
                j = k - 1 - i  # byte of the register (the earliest codon highest)
                np.bitwise_or(limbs[j // 8], aa[i : i + m] << np.uint64(8 * (j % 8)), out=limbs[j // 8])
            for part, limb in zip(parts, limbs):
                part.append(limb[valid])
    limbs = np.stack([np.concatenate(p) for p in parts])
    if n_limbs == 1:
        limbs = np.sort(limbs, axis=1)
    else:
        limbs = limbs[:, np.lexsort(limbs)]
    m = limbs.shape[1]
    first = np.ones(m, bool)
    first[1:] = (limbs[:, 1:] != limbs[:, :-1]).any(0)
    starts = np.flatnonzero(first)
    return limbs[:, starts], np.diff(np.append(starts, m)).astype(np.int64)


def join_limbs(limbs: np.ndarray) -> np.ndarray:
    """``(n_limbs, n)`` uint64 limbs, limb 0 lowest -> Python ints."""
    out = limbs[-1].astype(object)
    for limb in limbs[-2::-1]:
        out = (out << 64) | limb.astype(object)
    return out


def string_sixframe_counter(text: str, k: int) -> dict:
    """{register: count} of the six-frame amino-acid k-mers, from Python
    strings alone: each strand's three frames translated with the NCBI
    string, windows of k codons whose bases are all certain."""
    aa_of = {}
    for i, ch in enumerate(NCBI_STANDARD):
        aa_of["TCAG"[i >> 4] + "TCAG"[(i >> 2) & 3] + "TCAG"[i & 3]] = AA_CHARS.index(ch)
    text = text.upper().replace("U", "T")
    rc = text.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    out = collections.Counter()
    for strand in (text, rc):
        for f in range(3):
            aas = [aa_of.get(strand[i : i + 3]) for i in range(f, len(strand) - 2, 3)]
            for i in range(len(aas) - k + 1):
                w = aas[i : i + k]
                if None not in w:
                    out[sum(a << (8 * (k - 1 - j)) for j, a in enumerate(w))] += 1
    return dict(out)


# ---------------------------------------------------------------- timing


def median_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: int) -> float:
    """Least time to move ``n_bytes`` through device memory, in ms."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got, want) -> float:
    """Largest |got - want| over a result tuple (0.0 when bit-equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if not torch_equal(g, w):
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def torch_equal(a, b) -> bool:
    import torch

    return torch.equal(a.reshape(-1).cpu(), b.reshape(-1).cpu())


def device_profile(fn, reps: int = 1, warm: bool = False):
    """Run ``fn`` ``reps`` times under ``torch.profiler``: per call,
    ``(wall_s, busy_s, {category: device_s}, {kernel: [calls, device_s]})``;
    ``busy_s`` is the union of the device's kernel and copy intervals.  A
    tiny kernel (and with ``warm`` one untimed call of ``fn``) runs first,
    inside the trace: the trace can miss the device's first milliseconds
    of work.  Only device events that start inside the ``timed calls``
    range are counted."""
    import torch

    from kmers_tpu_torch.utils.profiling import annotate, trace

    with trace(None) as prof:
        torch.ones(1, device="cuda").add_(1)
        if warm:
            fn()
        torch.cuda.synchronize()
        with annotate("timed calls"):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == "timed calls")
    spans = []
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        # (the range itself also shows on the device's timeline)
        if e.device_type != torch.autograd.DeviceType.CUDA or e.time_range.start < start \
                or e.name == "timed calls":
            continue
        spans.append((e.time_range.start, e.time_range.end))
        per_name[e.name][0] += 1 / reps
        per_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e6 / reps
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    categories = collections.Counter()
    for name, (_, secs) in per_name.items():
        low = name.lower()
        if "k11_" in name:
            cat = "K11 bitonic_local_sort / bitonic_sort"
        elif "windows_k32_kernel" in name:
            cat = "K8b windows_k32"
        elif "k9_" in name:
            cat = "K9 merge_tables"
        elif "compact_" in name and "_kernel" in name:
            cat = "K10 compact_table"
        elif "sixframe_kernel" in name:
            cat = "K4/K5 sixframe_windows / sixframe_words"
        elif "canonical_windows_mw_kernel" in name:
            cat = "K3 canonical_words"
        elif "canonical_windows_kernel" in name:
            cat = "K1 canonical_windows / canonical_hashes"
        elif "general_windows_kernel" in name:
            cat = "K6 windows_general"
        elif "rle_unit_kernel" in name:
            cat = "K2 rle_unit"
        elif "dtod" in low:
            cat = "device-to-device copies"
        elif "dtoh" in low or "device -> pageable" in low or "device -> pinned" in low:
            cat = "download (D2H copies)"
        elif "htod" in low or "-> device" in low:
            cat = "upload (H2D copies)"
        elif "topk" in low or "kth" in low:
            cat = "torch.topk (radix select)"
        elif ("sort" in low or "radix" in low) and "searchsorted" not in low:
            cat = "torch.sort (radix sort)"
        else:
            cat = "other (elementwise, scan, gather, scatter, search)"
        categories[cat] += secs
    return wall, busy / 1e6 / reps, categories, per_name


@contextlib.contextmanager
def stage_timers(targets, sync: bool = True):
    """Wrap ``module.<name>`` for each ``(module, name)`` of ``targets``
    (a module or a class) with timers, synchronising the device around each
    call unless ``sync`` is false (host time only); yields {name: seconds}
    and restores the targets on exit."""
    import torch

    secs = collections.Counter()
    saved = {(module, name): getattr(module, name) for module, name in targets}

    def timed(name, fn):
        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        return run

    try:
        for (module, name), fn in saved.items():
            setattr(module, name, timed(name, fn))
        yield secs
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def stream_timers(targets):
    """Wrap ``module.<name>`` for each ``(module, name)`` of ``targets``
    with CUDA events on the current stream, adding no synchronisation;
    yields {name: [calls, ms]}, filled in on exit (after one synchronise):
    the stream time from each call's first enqueued kernel to its last."""
    import torch

    pairs = collections.defaultdict(list)
    saved = {(module, name): getattr(module, name) for module, name in targets}

    def timed(name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            pairs[name].append((start, end))
            return out
        return run

    totals = {}
    try:
        for (module, name), fn in saved.items():
            setattr(module, name, timed(name, fn))
        yield totals
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
        torch.cuda.synchronize()
        for name, events in pairs.items():
            totals[name] = [len(events), sum(a.elapsed_time(b) for a, b in events)]


def log_fold(tag: str, fn, merge_module, smi: str) -> dict:
    """Run ``fn`` once with the fold's two calls on CUDA-event timers (the
    merges of ``merge_module`` and the chunk compactions of the chunk loop)
    and log their stream time; returns {name: [calls, ms]}."""
    stream = importlib.import_module("kmers_tpu_torch.pipelines._stream")
    count_ops = importlib.import_module("kmers_tpu_torch.ops.count")
    targets = [(merge_module, "merge_compact_tables"), (stream, "compact_counts"),
               (count_ops, "merge_tables")]
    t0 = time.perf_counter()
    with stream_timers(targets) as fold:
        fn()
    wall = time.perf_counter() - t0
    merges = fold.get("merge_compact_tables", [0, 0.0])
    packs = fold.get("compact_counts", [0, 0.0])
    k9 = fold.get("merge_tables", [0, 0.0])
    total = merges[1] + packs[1]
    log(f"[{tag}] fold (CUDA events, {wall:.3f} s call): merges {merges[1]:.3f} ms over "
        f"{merges[0]} calls (K9, weighted RLE, K10), chunk compactions {packs[1]:.3f} ms over "
        f"{packs[0]} calls (K10); {total:.3f} ms in all; K9 {k9[1]:.3f} ms over {k9[0]} calls, "
        f"{100 * k9[1] / total if total else 0.0:.1f} % of the fold ({smi})")
    return fold


# ---------------------------------------------------------------- phases


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from kmers_tpu_torch.ops.kernels import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(f"[build] {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(flags: {' '.join(_build.NVCC_FLAGS)}; {len(_build._sources())} sources in parallel)")
    for name, usage in _build.resource_usage().items():
        log(f"[build] ptxas: {name}: {usage}")


def _views(buf, size, halo):
    """The four views every front-end is checked on: a whole chunk, a
    ragged one, and chunks at the odd offsets 1 and 33."""
    return [
        ("chunk", buf[:size]),
        ("ragged", buf[: size - halo + 7]),
        ("odd offset", buf[1 : 1 + size]),
        ("offset 33", buf[33 : 33 + size - 5]),
    ]


def _tile_edge_views(buf):
    """Views aimed at K1's and K3's packed tiles (TILE positions a block, 32
    bytes a code word): flagged bytes and N runs at the edges of code words
    and tiles, lengths around a tile and a chunk, and short views at the
    offsets 1-15 and 17; ``buf`` is a chunk of at least 2^20 bytes."""
    import torch

    from kmers_tpu_torch.ops.kernels.window_kernel import TILE

    L = 3 * TILE + 5
    edges = buf[: 2 * L].clone()
    edges[[0, 31, 32, 63, 64, TILE - 1, TILE, 2 * TILE - 1, 2 * TILE, L - 1]] = torch.tensor(
        list(b"NXR-nkYxmN"), dtype=torch.uint8, device=buf.device)
    edges[L + 20 : L + 50] = ord("N")  # across a code words' boundary
    edges[L + TILE - 10 : L + TILE + 40] = ord("n")  # across a tile's edge
    views = [("flags at word and tile edges", edges[:L]), ("N runs across code words", edges[L:])]
    views += [(f"length {n}", buf[:n]) for n in (TILE - 1, TILE, TILE + 1, CHUNK - 30)]
    views += [(f"offset {o}", buf[o : o + 16 * TILE - 3]) for o in [*range(1, 16), 17]]
    return views


def _sixframe_edge_views(buf, k):
    """Views aimed at K4's and K5's frame-major tiles (TILE anchors a block,
    32 bytes a code word, a halo of 3K - 1 bytes, codons in three frames),
    each with its bounds: flagged bytes at code-word, tile and halo edges, N
    runs across them, bounds outside the input, lengths 3K - 1 to 2^20 - 30
    and views at the offsets 1-15 and 17; the strands clipped differently
    where the view does not say otherwise.  ``buf`` is a chunk of at least
    2^20 bytes."""
    import torch

    from kmers_tpu_torch.ops.kernels.window_kernel import TILE

    L = 2 * TILE + 200
    clipped = (TILE - 5, L - 40, 3, 2 * TILE + 7)
    edges = buf[: 2 * L].clone()
    edges[[0, 31, 32, 63, 64, 97, TILE - 1, TILE, TILE + 3 * k - 2, 2 * TILE - 1, 2 * TILE,
           2 * TILE + 3 * k - 2, L - 1]] = torch.tensor(list(b"NR!nYx-kmN!Rn"), dtype=torch.uint8,
                                                        device=buf.device)
    edges[L + 20 : L + 50] = ord("N")  # across a code words' boundary
    edges[L + 96 : L + 128] = ord("n")  # exactly one code word
    edges[L + TILE - 10 : L + TILE + 40] = ord("N")  # across a tile's edge, in its halo
    edges[L + 2 * TILE - 40 : L + 2 * TILE + 100] = ord("R")
    views = [("flags at word and tile edges", edges[:L], clipped),
             ("N runs across code words and tiles", edges[L:], clipped),
             ("bounds outside the input", buf[:3000], (-5, 3100, -1000, 5000))]
    views += [(f"length {n}", buf[:n], (0, n, 0, n))
              for n in (3 * k - 1, 3 * k, TILE - 1, TILE, TILE + 1, CHUNK - 30)]
    n = 4 * TILE - 5
    views += [(f"offset {o}", buf[o : o + n], (3 * k, n - 7, 1, n // 2)) for o in [*range(1, 16), 17]]
    return views


def _general_edge_views(codes, good, bps, k):
    """Views aimed at K6's and K8b's packed code tiles (TILE positions a
    block, 32 symbols a group, one 32-symbol halo group), as (name, codes,
    good): bad symbols at group, tile and halo edges, bad runs across them,
    codes at the top of their range, lengths around a group, a tile and a
    chunk, and views at the offsets 1-15, 17 and 33.  ``codes`` and ``good``
    hold at least 2^20 + 64 symbols."""
    import torch

    from kmers_tpu_torch.ops.kernels.window_kernel import TILE

    L = 3 * TILE + 5
    g = good[: 2 * L].clone()
    # the last symbol a tile's last window reads and the halo group's last
    g[[0, 31, 32, 63, 64, TILE - 1, TILE, TILE + 1, TILE + k - 2, TILE + 31, 2 * TILE - 1, 2 * TILE,
       L - 1]] = False
    g[L + 20 : L + 50] = False  # across a groups' boundary
    g[L + TILE - 10 : L + TILE + 40] = False  # across a tile's edge, in its halo
    g[L + 2 * TILE - 40 : L + 2 * TILE + 100] = False
    top = torch.full((2 * TILE + 77,), (1 << bps) - 1, dtype=torch.uint8, device=codes.device)
    views = [("bad at group, tile and halo edges", codes[:L], g[:L]),
             ("bad runs across groups and tiles", codes[L : 2 * L], g[L:]),
             ("codes at the top of their range", top, good[: top.numel()])]
    views += [(f"length {n}", codes[:n], good[:n])
              for n in (k - 1, k, k + 1, 31, 32, 33, TILE - 1, TILE, TILE + 1, 1056, CHUNK - 1, CHUNK + 1)]
    n = 4 * TILE - 5
    views += [(f"offset {o}", codes[o : o + n], good[o : o + n]) for o in [*range(1, 16), 17, 33]]
    return views


def phase_kernels(chrom: np.ndarray):
    """Each kernel against its plain version; returns {name: entry of the
    kernels line, without launches}."""
    import torch

    from kmers_tpu_torch.convert import SENTINEL, n_words
    from kmers_tpu_torch.genetic_codes import ncbi_trans_table, standard_genetic_code
    from kmers_tpu_torch.ops.encode import classify_2bit
    from kmers_tpu_torch.ops.kernels.general_kernel import (
        windows_general,
        windows_general_plain,
        windows_k32,
        windows_k32_plain,
    )
    from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words, canonical_words_plain
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain
    from kmers_tpu_torch.ops.kernels.sixframe_kernel import (
        sixframe_windows,
        sixframe_windows_plain,
        sixframe_words,
        sixframe_words_plain,
    )
    from kmers_tpu_torch.ops.kernels.window_kernel import (
        canonical_hashes,
        canonical_hashes_plain,
        canonical_windows,
        canonical_windows_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    # front-end inputs: chunks with mixed case, N blocks, IUPAC codes and one
    # invalid byte, held in a buffer so views can start unaligned
    host = chrom[:CHUNK + 64].copy()
    host[1000:1300] = ord("N")
    host[rng.integers(0, host.size, 50)] = np.frombuffer(b"RYKMrykm-n", np.uint8)[rng.integers(0, 10, 50)]
    # one invalid byte inside every K3 view, one more inside every K1 view
    host[CHUNK_MW // 2] = ord("X")
    host[CHUNK // 2 + 1000] = ord("X")
    buf = torch.from_numpy(host[: CHUNK + 64]).to(dev)
    k1_err = 0.0
    for k in (1, 15, 31):
        for name, view in _views(buf, CHUNK, 30):
            got = canonical_windows(view, k)
            want = canonical_windows_plain(view, k)
            torch.cuda.synchronize()
            require(all(torch_equal(g, w) for g, w in zip(got, want)),
                    f"K1 != plain at K={k}, {name}")
            require(int(got[1]) == 2, f"K1 invalid count at K={k}, {name}")
            k1_err = max(k1_err, max_abs_err(got, want))
        log(f"[kernels] K1 canonical_windows K={k}: bit-equal to plain on 4 views "
            f"(n_invalid={int(got[1])}, n_ambig={int(got[2])})")
    clean = torch.from_numpy(chrom[:CHUNK].copy()).to(dev)
    # K1 (both modes) and K3 at the edges of their packed tiles
    edge_views = _tile_edge_views(clean)
    hash_err = k3_err = 0.0
    for kernel, plain, ks in [(canonical_windows, canonical_windows_plain, (1, 2, 15, 16, 31)),
                              (canonical_hashes, canonical_hashes_plain, (1, 2, 15, 16, 31)),
                              (canonical_words, canonical_words_plain, (32, 33, 47, 62, 63))]:
        for k in ks:
            for name, view in edge_views:
                got = kernel(view, k)
                want = plain(view, k)
                torch.cuda.synchronize()
                require(all(torch_equal(g, w) for g, w in zip(got, want)),
                        f"{kernel.__name__} != plain at K={k}, {name}")
                err = max_abs_err(got, want)
                if kernel is canonical_words:
                    k3_err = max(k3_err, err)
                elif kernel is canonical_hashes:
                    hash_err = max(hash_err, err)
                else:
                    k1_err = max(k1_err, err)
        log(f"[kernels] {kernel.__name__} K={ks}: bit-equal to plain on {len(edge_views)} views at "
            f"the packed tiles' edges")
    k1_ms = median_ms(lambda: canonical_windows(clean, K))
    k1_plain_ms = median_ms(lambda: canonical_windows_plain(clean, K))
    log(f"[kernels] K1 at 2^20 bytes, K=31: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    # device time per launch at the main paths' shapes, each beside its bound
    k1_us = {k: device_us(lambda: canonical_windows(clean, k), "canonical_windows_kernel") for k in (15, K)}
    log(f"[kernels] K1 device time at 2^20 bytes: K=15 {k1_us[15]:.2f} us, K={K} {k1_us[K]:.2f} us "
        f"(K=15 / K={K} = {k1_us[15] / k1_us[K]:.3f}), bound {1e3 * bound_ms(CHUNK * 9 + 16):.2f} us")
    # (phase 8 holds K1 against plain at this shape)
    big = torch.from_numpy(importlib.import_module("kmers_tpu_torch.pipelines.canonical_count").bench_input()).to(dev)
    k1_bench_us = device_us(lambda: canonical_windows(big, K), "canonical_windows_kernel")
    log(f"[kernels] K1 device time at bench's {big.shape[0]} bytes, K={K}: {k1_bench_us:.2f} us, "
        f"bound {1e3 * bound_ms(big.shape[0] * 9 + 16):.2f} us")
    del big

    # K1's hash mode: the same views; the byte counters equal register mode's
    for k in (1, 21, 31):
        for name, view in _views(buf, CHUNK, 30):
            got = canonical_hashes(view, k)
            want = canonical_hashes_plain(view, k)
            regs = canonical_windows(view, k)
            torch.cuda.synchronize()
            require(all(torch_equal(g, w) for g, w in zip(got, want)),
                    f"K1 hash mode != plain at K={k}, {name}")
            require(torch_equal(got[1], regs[1]) and torch_equal(got[2], regs[2]),
                    f"K1 hash mode counters at K={k}, {name}")
            require(torch.equal(got[0] == SENTINEL, regs[0] == SENTINEL),
                    f"K1 hash mode validity at K={k}, {name}")
            hash_err = max(hash_err, max_abs_err(got, want))
        log(f"[kernels] K1 canonical_hashes K={k}: bit-equal to plain on 4 views, "
            f"counters equal to register mode's (n_invalid={int(got[1])}, n_ambig={int(got[2])})")
    # the main path's shape: the whole chromosome in one launch
    whole = torch.from_numpy(chrom).to(dev)
    got = canonical_hashes(whole, K_SKETCH)
    want = canonical_hashes_plain(whole, K_SKETCH)
    require(all(torch_equal(g, w) for g, w in zip(got, want)), "K1 hash mode != plain on the chromosome")
    hash_err = max(hash_err, max_abs_err(got, want))
    del got, want
    hash_ms = median_ms(lambda: canonical_hashes(whole, K_SKETCH))
    hash_plain_ms = median_ms(lambda: canonical_hashes_plain(whole, K_SKETCH))
    hash_us = device_us(lambda: canonical_hashes(whole, K_SKETCH), "canonical_windows_kernel")
    log(f"[kernels] K1 hash mode on {chrom.size} bytes, K={K_SKETCH}: kernel {hash_ms:.4f} ms "
        f"({hash_us:.2f} us of device time), plain {hash_plain_ms:.4f} ms, bound "
        f"{bound_ms(chrom.size * 9 + 16):.4f} ms")

    # K6: codes below 2^bps with 0.5 % bad symbols, a view at an odd offset,
    # and views aimed at its packed code tiles; device time per launch at
    # 2^20 beside the bound (a code and a flag byte in, 8 bytes out)
    gen_err = 0.0
    flags = torch.from_numpy(rng.random(CHUNK + 64) > 0.005).to(dev)
    for bps, k, canonical in GENERAL_CASES:
        codes = torch.from_numpy(rng.integers(0, 1 << bps, CHUNK + 64).astype(np.uint8)).to(dev)
        c, g = codes[33 : 33 + CHUNK], flags[33 : 33 + CHUNK]
        got = windows_general(c, g, k, bps, canonical)
        want = windows_general_plain(c, g, k, bps, canonical)
        torch.cuda.synchronize()
        require(torch_equal(got, want), f"K6 != plain at bps={bps}, K={k}, canonical={canonical}")
        n_valid = int((got != SENTINEL).sum())
        require(CHUNK // 2 < n_valid < CHUNK - k, f"K6 valid windows at bps={bps}, K={k}")
        gen_err = max(gen_err, max_abs_err([got], [want]))
        views = _general_edge_views(codes, flags, bps, k)
        for name, vc, vg in views:
            got = windows_general(vc, vg, k, bps, canonical)
            want = windows_general_plain(vc, vg, k, bps, canonical)
            torch.cuda.synchronize()
            require(torch_equal(got, want), f"K6 != plain at bps={bps}, K={k}, canonical={canonical}, {name}")
            gen_err = max(gen_err, max_abs_err([got], [want]))
        us = device_us(
            lambda: windows_general(c, g, k, bps, canonical), "general_windows_kernel")
        bound_us = 1e3 * bound_ms(CHUNK * 10)
        log(f"[kernels] K6 windows_general bps={bps} K={k} canonical={canonical}: bit-equal to "
            f"plain on 2^20 symbols at offset 33 ({n_valid} valid windows) and on {len(views)} views at "
            f"the packed code tiles' edges; {us:.2f} us a launch at 2^20, bound {bound_us:.2f} us "
            f"({100 * bound_us / us:.0f} %)")
    # the main path's shape: extract_kmers' codes of the whole chromosome, K = 31
    codes, certain, _ = classify_2bit(whole)
    codes = codes.to(torch.uint8)
    got = windows_general(codes, certain, K, 2, False)
    want = windows_general_plain(codes, certain, K, 2, False)
    require(torch_equal(got, want), "K6 != plain on the chromosome")
    gen_err = max(gen_err, max_abs_err([got], [want]))
    # and minimizer_select's, K = 15 canonical
    got = windows_general(codes, certain, 15, 2, True)
    want = windows_general_plain(codes, certain, 15, 2, True)
    require(torch_equal(got, want), "K6 != plain on the chromosome at K = 15, canonical")
    gen_err = max(gen_err, max_abs_err([got], [want]))
    del got, want
    gen_ms = median_ms(lambda: windows_general(codes, certain, K, 2, False))
    gen_plain_ms = median_ms(lambda: windows_general_plain(codes, certain, K, 2, False))
    gen_us = device_us(lambda: windows_general(codes, certain, K, 2, False), "general_windows_kernel")
    gen15_us = device_us(lambda: windows_general(codes, certain, 15, 2, True), "general_windows_kernel")
    gen_bound_ms = bound_ms(chrom.size * (1 + 1 + 8))
    log(f"[kernels] K6 on {chrom.size} symbols, bps=2, K={K}: kernel {gen_ms:.4f} ms ({gen_us:.1f} us "
        f"of device time; K=15 canonical {gen15_us:.1f} us, K=15 / K={K} = {gen15_us / gen_us:.3f}), "
        f"plain {gen_plain_ms:.4f} ms, bound {gen_bound_ms:.4f} ms "
        f"({100 * gen_bound_ms / (gen_us / 1e3):.0f} %)")

    # K8b at K = 32: the same codes, forward and canonical, both planes; and
    # views aimed at its packed code tiles
    k32_err = 0.0
    views = _general_edge_views(codes[: CHUNK + 64], certain[: CHUNK + 64] & flags, 2, 32)
    for canonical in (False, True):
        for name, vc, vg in views:
            got = windows_k32(vc, vg, canonical)
            want = windows_k32_plain(vc, vg, canonical)
            torch.cuda.synchronize()
            require(all(torch_equal(g, w) for g, w in zip(got, want)),
                    f"K8b (K = 32) != plain, canonical={canonical}, {name}")
            k32_err = max(k32_err, max_abs_err(got, want))
    log(f"[kernels] K8b windows_k32: both planes bit-equal to plain on {len(views)} views at the packed "
        f"code tiles' edges, forward and canonical")
    for canonical in (False, True):
        got = windows_k32(codes, certain, canonical)
        want = windows_k32_plain(codes, certain, canonical)
        require(all(torch_equal(g, w) for g, w in zip(got, want)),
                f"K8b (K = 32) != plain on the chromosome, canonical={canonical}")
        n_valid = int(got[1].sum())
        require(chrom.size // 2 < n_valid < chrom.size - 31, f"K8b valid windows, canonical={canonical}")
        k32_err = max(k32_err, max_abs_err(got, want))
        log(f"[kernels] K8b windows_k32 canonical={canonical}: both planes bit-equal to plain on "
            f"{chrom.size} symbols ({n_valid} valid windows)")
    del got, want
    k32_ms = median_ms(lambda: windows_k32(codes, certain, True))
    k32_plain_ms = median_ms(lambda: windows_k32_plain(codes, certain, True))
    k32_us = device_us(lambda: windows_k32(codes, certain, True), "windows_k32_kernel")
    log(f"[kernels] K8b on {chrom.size} symbols, K=32 canonical: kernel {k32_ms:.4f} ms "
        f"({k32_us:.1f} us of device time), plain {k32_plain_ms:.4f} ms, bound "
        f"{bound_ms(chrom.size * 11):.4f} ms ({100 * bound_ms(chrom.size * 11) / (k32_us / 1e3):.0f} %)")
    del whole, codes, certain

    for k in (32, 33, 47, 63):
        for name, view in _views(buf, CHUNK_MW, 62):
            got = canonical_words(view, k)
            want = canonical_words_plain(view, k)
            torch.cuda.synchronize()
            require(got[0].shape == (n_words(k), view.shape[0]), f"K3 shape at K={k}, {name}")
            require(all(torch_equal(g, w) for g, w in zip(got, want)),
                    f"K3 != plain at K={k}, {name}")
            require(int(got[1]) == 1, f"K3 invalid count at K={k}, {name}")
            require(int((got[0][0] != SENTINEL).sum()) > view.shape[0] // 2,
                    f"K3 valid windows at K={k}, {name}")
            k3_err = max(k3_err, max_abs_err(got, want))
        log(f"[kernels] K3 canonical_words K={k}: bit-equal to plain on 4 views "
            f"(n_invalid={int(got[1])}, n_ambig={int(got[2])})")
    clean_mw = clean[:CHUNK_MW]
    k3_ms = median_ms(lambda: canonical_words(clean_mw, K_MW))
    k3_plain_ms = median_ms(lambda: canonical_words_plain(clean_mw, K_MW))
    log(f"[kernels] K3 at 2^19 bytes, K=47: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms")
    k3_us = {k: device_us(lambda: canonical_words(clean_mw, k), "canonical_windows_mw_kernel")
             for k in (K_MW, 63)}
    log("[kernels] K3 device time at 2^19 bytes: " + ", ".join(
        f"K={k} {us:.2f} us (bound {1e3 * bound_ms(CHUNK_MW * (1 + 8 * n_words(k)) + 16):.2f} us)"
        for k, us in k3_us.items()))

    # K4 and K5: the strands clipped differently, as the JAX kernel's
    # callers clip them (fw [H, H + b), rv [1, b + 1))
    sixframe_err = {"sixframe_windows": 0.0, "sixframe_words": 0.0}
    for k in (1, 5, 7, 8, 15, 32):
        kernel, plain = ((sixframe_windows, sixframe_windows_plain) if k <= 7
                         else (sixframe_words, sixframe_words_plain))
        for name, view in _views(buf, CHUNK, 20):
            H = 3 * k
            b = view.shape[0] - 2 * H - 5
            bounds = (H, H + b, 1, b + 1)
            got = kernel(view, k, bounds)
            want = plain(view, k, bounds)
            torch.cuda.synchronize()
            require(all(torch_equal(g, w) for g, w in zip(got, want)),
                    f"{kernel.__name__} != plain at K={k}, {name}")
            require(int(got[1]) > view.shape[0], f"{kernel.__name__} valid windows at K={k}, {name}")
            sixframe_err[kernel.__name__] = max(sixframe_err[kernel.__name__], max_abs_err(got, want))
        log(f"[kernels] {'K4' if k <= 7 else 'K5'} {kernel.__name__} K={k}: bit-equal to plain on "
            f"4 views (n_valid={int(got[1])})")
    # K4 and K5 at the edges of their frame-major tiles, in two genetic codes
    for k in SIXFRAME_EDGE_KS:
        kernel, plain = ((sixframe_windows, sixframe_windows_plain) if k <= 7
                         else (sixframe_words, sixframe_words_plain))
        views = _sixframe_edge_views(clean, k)
        for name, view, bounds in views:
            for code in (standard_genetic_code, ncbi_trans_table[2]):
                got = kernel(view, k, bounds, code)
                want = plain(view, k, bounds, code)
                torch.cuda.synchronize()
                require(all(torch_equal(g, w) for g, w in zip(got, want)),
                        f"{kernel.__name__} != plain at K={k}, {name}, {code.name}")
                sixframe_err[kernel.__name__] = max(sixframe_err[kernel.__name__], max_abs_err(got, want))
        log(f"[kernels] {'K4' if k <= 7 else 'K5'} {kernel.__name__} K={k}: bit-equal to plain on "
            f"{len(views)} views at the frame-major tiles' edges, in two genetic codes")
    every = (0, CHUNK, 0, CHUNK)
    k4_ms = median_ms(lambda: sixframe_windows(clean, K_AA, every))
    k4_plain_ms = median_ms(lambda: sixframe_windows_plain(clean, K_AA, every))
    k5_ms = median_ms(lambda: sixframe_words(clean, K_AA_MW, every))
    k5_plain_ms = median_ms(lambda: sixframe_words_plain(clean, K_AA_MW, every))
    log(f"[kernels] K4 at 2^20 bytes, K={K_AA}: kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms; "
        f"K5 at K={K_AA_MW}: kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms")
    # device time per launch at 2^20 bytes, each beside its bound: one byte
    # in, 2 W 8-byte words out per anchor, the counter
    sixframe_us = {}
    for k in (1, K_AA, 8, K_AA_MW, 32):
        kernel = sixframe_windows if k <= 7 else sixframe_words
        sixframe_us[k] = device_us(lambda: kernel(clean, k, every), "sixframe_kernel")
        bound_us = 1e3 * bound_ms(CHUNK * (1 + 16 * n_words(k, 8)) + 8)
        log(f"[kernels] {'K4' if k <= 7 else 'K5'} device time at 2^20 bytes, K={k}: "
            f"{sixframe_us[k]:.2f} us, bound {bound_us:.2f} us ({100 * bound_us / sixframe_us[k]:.0f} %)")

    # K2 inputs
    n = CHUNK
    long_run = torch.cat([torch.full((n // 2,), 12345), torch.arange(n // 2) + 20000])
    straddle = torch.repeat_interleave(torch.arange(n // 251 + 1), 251)[:n]
    tail = torch.sort(torch.from_numpy(rng.integers(0, 1 << 62, n))).values
    tail[-50_000:] = SENTINEL
    sorted_chunk = torch.sort(canonical_windows(clean, K)[0]).values
    cases = {
        "one run of 2^19": long_run,
        "runs straddling blocks": straddle,
        "sentinel tail": tail,
        "all unique": torch.arange(n) * 7,
        "sorted K1 chunk": sorted_chunk.cpu(),
        "n = 0": torch.zeros(0, dtype=torch.int64),
    }
    k2_err = 0.0
    for name, keys in cases.items():
        keys = keys.to(dev)
        got = rle_unit(keys)
        want = rle_unit_plain(keys)
        torch.cuda.synchronize()
        require(all(torch_equal(g, w) for g, w in zip(got, want)), f"K2 != plain: {name}")
        k2_err = max(k2_err, max_abs_err(got, want))
        log(f"[kernels] K2 rle_unit {name}: bit-equal to plain (n_unique={int(got[2])})")
    k2_ms = median_ms(lambda: rle_unit(sorted_chunk))
    k2_plain_ms = median_ms(lambda: rle_unit_plain(sorted_chunk))
    # the one PyTorch call that run-length encodes a sorted stream
    k2_lib_ms = median_ms(lambda: torch.unique_consecutive(sorted_chunk, return_counts=True))
    log(f"[kernels] K2 at 2^20 keys: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, "
        f"torch.unique_consecutive {k2_lib_ms:.4f} ms")

    merge_entry, compact_entry = kernels_fold(clean)
    local_entry, sort_entry = kernels_sort()

    W = n_words(K_MW)
    W_AA = n_words(K_AA_MW, 8)
    return {
        "merge_tables": merge_entry,
        "compact_table": compact_entry,
        "bitonic_local_sort": local_entry,
        "bitonic_sort": sort_entry,
        "windows_k32": dict(
            route="cuda", source="kmers_tpu_torch/csrc/general_kernel.cu",
            replaces="kmers_tpu/ops/pallas/window_kernel.py:634",
            max_abs_err=k32_err, ms=k32_ms, plain_ms=k32_plain_ms,
            # a uint8 code and a bool flag in, an 8-byte register and a bool out per position
            bound_ms=bound_ms(chrom.size * (2 + 9)), bound_by="bytes", library_ms=None,
            device_us=k32_us,
        ),
        "canonical_windows": dict(
            route="cuda", source="kmers_tpu_torch/csrc/window_kernel.cu",
            replaces="kmers_tpu/ops/pallas/window_kernel.py:518",
            max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
            # one byte in, one 8-byte register out per position; counters
            bound_ms=bound_ms(CHUNK * (1 + 8) + 16), bound_by="bytes", library_ms=None,
        ),
        "rle_unit": dict(
            route="cuda", source="kmers_tpu_torch/csrc/rle_kernel.cu",
            replaces="kmers_tpu/ops/pallas/rle_kernel.py:150",
            max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
            # one 8-byte key in, an 8-byte key and count out per slot
            bound_ms=bound_ms(n * 24 + 8), bound_by="bytes", library_ms=k2_lib_ms,
        ),
        "canonical_words": dict(
            route="cuda", source="kmers_tpu_torch/csrc/multiword_kernel.cu",
            replaces="kmers_tpu/ops/pallas/multiword_kernel.py:186",
            max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms,
            # one byte in, W 8-byte words out per position; counters
            bound_ms=bound_ms(CHUNK_MW * (1 + 8 * W) + 16), bound_by="bytes", library_ms=None,
        ),
        "canonical_hashes": dict(
            route="cuda", source="kmers_tpu_torch/csrc/window_kernel.cu",
            replaces="kmers_tpu/ops/pallas/window_kernel.py:518",
            max_abs_err=hash_err, ms=hash_ms, plain_ms=hash_plain_ms,
            # one byte in, one 8-byte hash key out per position; counters
            bound_ms=bound_ms(chrom.size * (1 + 8) + 16), bound_by="bytes", library_ms=None,
        ),
        "windows_general": dict(
            route="cuda", source="kmers_tpu_torch/csrc/general_kernel.cu",
            replaces="kmers_tpu/ops/pallas/general_kernel.py:80",
            max_abs_err=gen_err, ms=gen_ms, plain_ms=gen_plain_ms,
            # a uint8 code and a bool flag in, one 8-byte register out per position
            bound_ms=gen_bound_ms, bound_by="bytes", library_ms=None,
            device_us=gen_us,
        ),
        "sixframe_windows": dict(
            route="cuda", source="kmers_tpu_torch/csrc/sixframe_kernel.cu",
            replaces="kmers_tpu/ops/pallas/sixframe_kernel.py:229",
            max_abs_err=sixframe_err["sixframe_windows"], ms=k4_ms, plain_ms=k4_plain_ms,
            # one byte in, two 8-byte keys (both strands) out per anchor; the counter
            bound_ms=bound_ms(CHUNK * (1 + 16) + 8), bound_by="bytes", library_ms=None,
        ),
        "sixframe_words": dict(
            route="cuda", source="kmers_tpu_torch/csrc/sixframe_kernel.cu",
            replaces="kmers_tpu/ops/pallas/sixframe_kernel.py:365",
            max_abs_err=sixframe_err["sixframe_words"], ms=k5_ms, plain_ms=k5_plain_ms,
            # one byte in, 2 W 8-byte words (both strands) out per anchor; the counter
            bound_ms=bound_ms(CHUNK * (1 + 16 * W_AA) + 8), bound_by="bytes", library_ms=None,
        ),
    }


def device_us(fn, marker: str, reps: int = 5, tries: int = 3) -> float:
    """Device time of one launch of each kernel whose name holds
    ``marker``, summed over those kernels (``torch.profiler``), in
    microseconds; per launch seen, so a launch the trace drops does not
    lower it.  A trace that shows no such launch at all is taken again, at
    most ``tries`` times in all (a trace can come back with no device
    events); after that the time is the median of ``reps`` CUDA-event
    timings of one call of ``fn``, its stream time, logged as such."""
    for _ in range(tries):
        _, _, _, per_name = device_profile(fn, reps, warm=True)
        seen = [(calls, secs) for name, (calls, secs) in per_name.items() if marker in name and calls]
        if seen:
            return 1e6 * sum(secs / calls for calls, secs in seen)
        log(f"[profile] no launch of {marker} in the trace ({len(per_name)} device events: "
            f"{sorted(per_name)[:6]})")
    us = 1e3 * median_ms(fn, reps)
    log(f"[profile] {marker}: {us:.2f} us of stream time a call from CUDA events, not from the profiler")
    return us


def kernels_fold(clean):
    """K9 and K10 against their plain versions at edge cases and at the
    main paths' shapes; returns their entries of the kernels line."""
    import torch

    from kmers_tpu_torch.convert import SENTINEL
    from kmers_tpu_torch.ops.count import compact_counts, sort_count
    from kmers_tpu_torch.ops.kernels.merge_kernel import (
        MERGE_TILE,
        compact_table,
        compact_table_plain,
        merge_tables,
        merge_tables_plain,
    )
    from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words
    from kmers_tpu_torch.ops.kernels.sixframe_kernel import sixframe_windows
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows
    from kmers_tpu_torch.ops.multiword import sort_count_mw

    dev = torch.device("cuda")

    def counts_for(keys, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(1, 1 << 40, keys.shape, generator=g, device=dev)

    def chunk_table(view):
        uniq, counts, nu = sort_count(canonical_windows(view, K)[0])
        keys, counts = compact_counts(uniq, counts)
        return keys[: int(nu)].contiguous(), counts[: int(nu)].contiguous()

    # chunk tables of two overlapping K = 31 chunks (shared keys tie)
    ka, ca = chunk_table(clean)
    kb, cb = chunk_table(clean[CHUNK // 2 :])
    # the K = 31 fold's last merge: sorted distinct random keys, 33 M and
    # 14 M rows, a sixteenth of A's keys also in B
    g = torch.Generator(device=dev).manual_seed(31)
    big_a = torch.unique(torch.randint(0, 1 << 62, (33_000_000,), generator=g, device=dev))
    big_b = torch.unique(torch.cat([big_a[::16], torch.randint(0, 1 << 62, (12_000_000,), generator=g,
                                                                device=dev)]))
    big = (big_a, counts_for(big_a, 1), big_b, counts_for(big_b, 2))
    dup_a = torch.repeat_interleave(torch.arange(10, device=dev), 3000)
    dup_b = torch.repeat_interleave(torch.arange(10, device=dev), 2100)
    sent_b = kb.clone()
    sent_b[-1000:] = SENTINEL
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    tile = MERGE_TILE
    # one key in a run of 2.5 merge tiles in each table: tile boundaries, and
    # so co-ranks, fall inside the run that A and B share
    pivot = int(ka[ka.numel() // 2])
    run = torch.full((5 * tile // 2,), pivot, dtype=torch.int64, device=dev)
    run_a = torch.cat([ka[ka < pivot][-3000:], run, ka[ka > pivot][:3000]])
    run_b = torch.cat([kb[kb < pivot][-5000:], run, kb[kb > pivot][:7000]])
    real_a = ka != SENTINEL
    low_a, low_ca = ka[real_a] - (1 << 62), ca[real_a]  # every key of A below every key of B
    cases = {
        "heavy duplication": (dup_a, counts_for(dup_a, 3), dup_b, counts_for(dup_b, 4)),
        "a run shared across tiles": (run_a, counts_for(run_a, 6), run_b, counts_for(run_b, 7)),
        "a empty": (empty, empty, kb, cb),
        "b empty": (ka, ca, empty, empty),
        "every key of a below b": (low_a, low_ca, kb, cb),
        "every key of b below a": (kb, cb, low_a, low_ca),
        "one row each": (ka[:1], ca[:1], ka[:1], cb[:1]),
        "a single row": (kb[777:778], cb[777:778], ka, ca),
        "odd lengths": (ka[:2049], ca[:2049], kb[:6143], cb[:6143]),
        "not multiples of the tile": (ka[: tile + 1], ca[: tile + 1], kb[: 3 * tile - 3], cb[: 3 * tile - 3]),
        "starts off 16-byte boundaries": (ka[1:], ca[1:], kb[3:], cb[3:]),
        "sentinel tail": (ka, ca, sent_b, cb),
        "chunk tables": (ka, ca, kb, cb),
        "last-merge shape": big,
    }
    k9_err = 0.0
    for name, args in cases.items():
        got = merge_tables(*args)
        want = merge_tables_plain(*args)
        torch.cuda.synchronize()
        require(all(torch_equal(g_, w_) for g_, w_ in zip(got, want)), f"K9 != plain: {name}")
        k9_err = max(k9_err, max_abs_err(got, want))
        log(f"[kernels] K9 merge_tables {name} ({args[0].numel()} + {args[2].numel()} rows): "
            "bit-equal to plain")
    n_chunk = ka.numel() + kb.numel()
    chunk_ms = median_ms(lambda: merge_tables(ka, ca, kb, cb))
    _, _, _, chunk_prof = device_profile(lambda: merge_tables(ka, ca, kb, cb), reps=5, warm=True)
    n_big = big_a.numel() + big_b.numel()
    k9_ms = median_ms(lambda: merge_tables(*big))
    k9_plain_ms = median_ms(lambda: merge_tables_plain(*big))
    cat = torch.cat([big_a, big_b])
    # the call the merges made before K9: the sort of the concatenated keys
    # with its indices
    k9_lib_ms = median_ms(lambda: torch.sort(cat, stable=True))
    del cat
    _, _, _, big_prof = device_profile(lambda: merge_tables(*big), reps=5, warm=True)
    k9_us = 1e6 * sum(secs / calls for name, (calls, secs) in big_prof.items() if "k9_" in name and calls)
    chunk_us = 1e6 * sum(secs / calls for name, (calls, secs) in chunk_prof.items() if "k9_" in name and calls)
    log(f"[kernels] K9 at {ka.numel()} + {kb.numel()} rows: kernel {chunk_ms:.4f} ms ({chunk_us:.1f} us "
        f"of device time: {per_launch(chunk_prof, 'k9_')}), bound {bound_ms(32 * n_chunk):.4f} ms; at "
        f"{big_a.numel()} + {big_b.numel()} rows: kernel {k9_ms:.4f} ms ({k9_us:.1f} us of device "
        f"time: {per_launch(big_prof, 'k9_')}), plain {k9_plain_ms:.4f} ms, torch.sort with indices "
        f"{k9_lib_ms:.4f} ms, bound {bound_ms(32 * n_big):.4f} ms")
    del big, big_a, big_b

    # K10 on chunk tables: K = 31 (2^20), six-frame K = 7 (2^21), K = 47
    # (two words of 2^19)
    t31 = sort_count(canonical_windows(clean, K)[0])[:2]
    t_aa = sort_count(sixframe_windows(clean, K_AA, (0, CHUNK, 0, CHUNK))[0])[:2]
    t47 = sort_count_mw(canonical_words(clean[:CHUNK_MW], K_MW)[0])[:2]
    k10_err = 0.0
    zeros = torch.zeros(CHUNK, dtype=torch.int64, device=dev)
    for name, (keys, counts) in {
        "K = 31 chunk table (2^20)": t31, "six-frame chunk table (2^21)": t_aa,
        "K = 47 chunk table (2 x 2^19)": t47, "no real row": (t31[0], zeros),
        "every row real": (t31[0], counts_for(t31[0], 5)), "2049 rows": (t31[0][:2049], t31[1][:2049]),
    }.items():
        got = compact_table(keys, counts)
        want = compact_table_plain(keys, counts)
        torch.cuda.synchronize()
        require(all(torch_equal(g_, w_) for g_, w_ in zip(got, want)), f"K10 != plain: {name}")
        k10_err = max(k10_err, max_abs_err(got, want))
        log(f"[kernels] K10 compact_table {name}: bit-equal to plain ({int((counts > 0).sum())} real "
            f"of {counts.numel()} rows)")
    keys, counts = t31
    k10_ms = median_ms(lambda: compact_table(keys, counts))
    k10_plain_ms = median_ms(lambda: compact_table_plain(keys, counts))
    real = counts > 0
    # one call for the front-packed rows (without the tail)
    k10_lib_ms = median_ms(lambda: torch.masked_select(keys, real))
    k10_us = device_us(lambda: compact_table(keys, counts), "compact_")
    aa_ms = median_ms(lambda: compact_table(*t_aa))
    w47_ms = median_ms(lambda: compact_table(*t47))
    log(f"[kernels] K10 at 2^20 rows: kernel {k10_ms:.4f} ms ({k10_us:.1f} us of device time, three "
        f"launches), plain {k10_plain_ms:.4f} ms, torch.masked_select {k10_lib_ms:.4f} ms, bound "
        f"{bound_ms(32 * CHUNK):.5f} ms; at 2^21 rows {aa_ms:.4f} ms; at 2 x 2^19 words {w47_ms:.4f} ms")
    merge_entry = dict(
        route="cuda", source="kmers_tpu_torch/csrc/merge_kernel.cu",
        replaces="kmers_tpu/ops/pallas/merge_kernel.py:99",
        max_abs_err=k9_err, ms=k9_ms, plain_ms=k9_plain_ms,
        # a 16-byte row (key, count) read once and written once
        bound_ms=bound_ms(32 * n_big), bound_by="bytes", library_ms=k9_lib_ms,
        device_us=k9_us, chunk_shape_ms=chunk_ms, chunk_shape_rows=n_chunk,
    )
    compact_entry = dict(
        route="cuda", source="kmers_tpu_torch/csrc/merge_kernel.cu",
        replaces="kmers_tpu/ops/pallas/merge_kernel.py:206",
        max_abs_err=k10_err, ms=k10_ms, plain_ms=k10_plain_ms,
        # a 16-byte row (key, count) read once and written once
        bound_ms=bound_ms(32 * CHUNK), bound_by="bytes", library_ms=k10_lib_ms,
        device_us=k10_us,
    )
    return merge_entry, compact_entry


def _kernel_label(name: str) -> str:
    """``k11_tile_kernel<16>`` of a profiler name such as
    ``(anonymous namespace)::k11_tile_kernel<16>(long const*, long*, long, int, bool)``
    (K9's and K11's kernels are named ``k9_...`` and ``k11_...``)."""
    start = min(i for i in (name.find("k9_"), name.find("k11_"), len(name)) if i >= 0)
    return name[start:].split("(")[0]


def per_launch(per_name: dict, marker: str) -> str:
    """Device time per launch of each kernel whose name holds ``marker``."""
    return ", ".join(f"{_kernel_label(name)} {calls:g} launches, {1e6 * secs / calls:.1f} us each"
                     for name, (calls, secs) in per_name.items() if marker in name and calls)


def kernels_sort():
    """K11 against its plain version on edge cases and at ``SORT_SHAPES``,
    the full sort also against ``torch.sort``; times at ``SORT_TIMED``;
    returns the entries of the local pass and of the full sort for the
    kernels line."""
    import torch

    from kmers_tpu_torch.convert import SENTINEL
    from kmers_tpu_torch.ops import bitonic_local_sort, bitonic_sort
    from kmers_tpu_torch.ops.kernels.sort_kernel import (
        DEFAULT_TILE,
        bitonic_local_sort_plain,
        bitonic_sort_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    tile = DEFAULT_TILE
    lo, hi = torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).max

    def rand(n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)

    keys = rand(2 * tile)
    extremes = keys.clone()
    extremes[::97] = lo
    extremes[5::89] = hi
    sentinels = keys.clone()
    sentinels[torch.rand(2 * tile, generator=g, device=dev) < 0.3] = SENTINEL
    # runs of one key longer than a tile, so that equal keys meet at every
    # merge round's run boundaries: in order, reversed and shuffled
    runs = torch.arange(1 << 18, device=dev) // 12_289
    shuffled = runs[torch.randperm(runs.numel(), generator=g, device=dev)]
    cases = {
        "n = tile": keys[:tile].contiguous(),
        "n = 2 tiles": keys,
        "all equal": torch.full((2 * tile,), 7, dtype=torch.int64, device=dev),
        "all SENTINEL": torch.full((2 * tile,), SENTINEL, dtype=torch.int64, device=dev),
        "already sorted": torch.sort(keys).values,
        "reverse sorted": torch.sort(keys, descending=True).values,
        "INT64_MIN and INT64_MAX present": extremes,
        "30 % sentinels": sentinels,
        "duplicate runs across merge rounds": runs,
        "duplicate runs across merge rounds, reversed": torch.flip(runs, [0]),
        "duplicate runs across merge rounds, shuffled": shuffled,
        "few distinct keys": shuffled % 3 - 1,
        "starts off a 16-byte boundary": rand(2 * tile + 2)[1 : 2 * tile + 1],
    }
    err = 0.0
    for name, keys in cases.items():
        got, local = bitonic_sort(keys), bitonic_local_sort(keys, tile)
        want, want_local = bitonic_sort_plain(keys), bitonic_local_sort_plain(keys, tile)
        torch.cuda.synchronize()
        require(torch_equal(got, want) and torch.equal(got, torch.sort(keys).values),
                f"K11 full sort != plain or torch.sort: {name}")
        require(torch_equal(local, want_local), f"K11 local pass != plain: {name}")
        err = max(err, max_abs_err([got, local], [want, want_local]))
        log(f"[kernels] K11 {name} ({keys.numel()} keys, tile {tile}): local pass and full sort "
            "bit-equal to plain, full sort equal to torch.sort")
    for n in SORT_SHAPES:
        keys = rand(n)
        got, local = bitonic_sort(keys), bitonic_local_sort(keys, tile)
        require(torch.equal(local, bitonic_local_sort_plain(keys, tile)), f"K11 local pass != plain at {n}")
        require(torch.equal(got, bitonic_sort_plain(keys)), f"K11 full sort != plain at {n}")
        require(torch.equal(got, torch.sort(keys).values), f"K11 full sort != torch.sort at {n}")
        log(f"[kernels] K11 at {n} keys: local pass (tile {tile}) bit-equal to plain, full sort "
            "bit-equal to plain and to torch.sort")
        if n == SORT_TIMED:
            timed = keys
        del got, local
    n, keys = SORT_TIMED, timed
    ms = median_ms(lambda: bitonic_sort(keys))
    plain_ms = median_ms(lambda: bitonic_sort_plain(keys), reps=5)
    lib_ms = median_ms(lambda: torch.sort(keys))
    local_ms = median_ms(lambda: bitonic_local_sort(keys, tile))
    local_plain_ms = median_ms(lambda: bitonic_local_sort_plain(keys, tile), reps=5)
    # all tiles ascending: the nearest PyTorch call to the local pass, not the same function
    seg_ms = median_ms(lambda: torch.sort(keys.view(-1, tile), dim=1))
    _, _, _, per_name = device_profile(lambda: bitonic_sort(keys), reps=3, warm=True)
    device_ms = 1e3 * sum(secs for name, (_, secs) in per_name.items() if "k11_" in name)
    _, _, _, local_prof = device_profile(lambda: bitonic_local_sort(keys, tile), reps=3, warm=True)
    log(f"[kernels] K11 at {n} keys: bitonic_sort {ms:.4f} ms ({device_ms:.4f} ms of device time: "
        f"{per_launch(per_name, 'k11_')}), plain {plain_ms:.4f} ms, torch.sort {lib_ms:.4f} ms; local "
        f"pass {local_ms:.4f} ms ({per_launch(local_prof, 'k11_')}), plain {local_plain_ms:.4f} ms, "
        f"torch.sort of the {n // tile} tiles (all ascending) {seg_ms:.4f} ms; bound "
        f"{bound_ms(16 * n):.4f} ms")
    common = dict(route="cuda", source="kmers_tpu_torch/csrc/sort_kernel.cu", max_abs_err=err,
                  # an 8-byte key read once and written once
                  bound_ms=bound_ms(16 * n), bound_by="bytes")
    local_entry = dict(common, replaces="kmers_tpu/ops/pallas/sort_kernel.py:136", ms=local_ms,
                       plain_ms=local_plain_ms, library_ms=None)
    sort_entry = dict(common, replaces="kmers_tpu/ops/pallas/sort_kernel.py:147", ms=ms,
                      plain_ms=plain_ms, library_ms=lib_ms, device_ms=device_ms)
    return local_entry, sort_entry


def _check_cli(chrom: np.ndarray, k: int):
    """The CLI on a 3-record FASTA: totals equal to the numpy reference."""
    L = chrom.size
    records = [chrom[200_000:400_000], chrom[500_000:501_000], chrom[L // 2 - 30_000 : L // 2 + 20_000]]
    ref = numpy_reference(np.concatenate([np.concatenate([r, [ord("N")]]) for r in records])[:-1], k)
    with tempfile.TemporaryDirectory() as tmp:
        fa = Path(tmp) / "reads.fa"
        fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, r.tobytes()) for i, r in enumerate(records)))
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        proc = subprocess.run(
            [sys.executable, "-m", "kmers_tpu_torch", "count", str(fa), "-k", str(k), "--top", "3"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
    require(proc.returncode == 0, f"CLI failed at K={k}: {proc.stderr[-2000:]}")
    totals = json.loads(proc.stderr.strip().splitlines()[-1])
    require(totals == {"distinct": int(ref[1].size), "total": int(ref[1].sum())},
            f"CLI totals {totals} at K={k}")
    top = proc.stdout.strip().splitlines()
    require(len(top) == 3 and all(len(line.split("\t")[0]) == k for line in top), f"CLI top lines at K={k}")
    log(f"[slice K={k}] CLI on a 3-record FASTA: {totals}")


def require_fold_launches(launches: dict, n_chunks: int, merges: bool) -> None:
    """The front-end and K2 once a chunk; K10 once a chunk and once a merge
    of the level stack (n_chunks - 1 merges); K9 once a merge where tables
    are one word (``merges``), never for word tables.  One chunk is neither
    compacted nor merged."""
    front = [name for name in launches if name not in ("rle_unit", "merge_tables", "compact_table")]
    for name in [*front, "rle_unit"]:
        require(launches[name] >= n_chunks, f"{name} launched {launches[name]} times for {n_chunks} chunks")
    want = {"merge_tables": n_chunks - 1 if merges else 0,
            "compact_table": 2 * n_chunks - 1 if n_chunks > 1 else 0}
    got = {name: launches[name] for name in want}
    require(got == want, f"fold launches {got}, expected {want} for {n_chunks} chunks")


def phase_slice(chrom: np.ndarray, smi: str):
    """The K = 31 path; returns its launch counts and its table, which is
    checked equal to the numpy reference."""
    import torch

    from kmers_tpu_torch import CountConfig, canonical_count_bytes
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows

    tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
    cfg = CountConfig(K=K)
    L = chrom.size
    n_chunks = len(range(0, L - K + 1, cfg.resolved_chunk_size - (K - 1)))
    # warm-up on 3 chunks' worth (first use of torch's sort and scan kernels)
    canonical_count_bytes(chrom[: 3 * CHUNK], cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    canonical_windows.launches = 0
    rle_unit.launches = 0
    merge_tables.launches = 0
    compact_table.launches = 0
    t0 = time.perf_counter()
    kmers, counts = canonical_count_bytes(chrom, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {"canonical_windows": canonical_windows.launches, "rle_unit": rle_unit.launches,
                "merge_tables": merge_tables.launches, "compact_table": compact_table.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice K={K}] {L} bases, {n_chunks} chunks of 2^20: {wall:.3f} s wall, "
        f"{L / wall:.0f} bases/s, {kmers.size} distinct, {int(counts.sum())} counted, "
        f"peak device memory {peak} bytes ({smi})")
    log(f"[slice K={K}] launches during the run: {launches}")
    require_fold_launches(launches, n_chunks, merges=True)
    log_fold(f"slice K={K}", lambda: canonical_count_bytes(chrom, cfg, device="cuda"), tcc, smi)
    _log_profile(f"slice K={K}", lambda: canonical_count_bytes(chrom, cfg, device="cuda"), smi, reps=1)

    require(kmers.dtype == np.uint64 and counts.dtype == np.int64, "output dtypes")
    t0 = time.perf_counter()
    ref_w, ref_c = numpy_reference(chrom, K)
    log(f"[slice K={K}] numpy reference in {time.perf_counter() - t0:.1f} s: {ref_c.size} distinct")
    require(np.array_equal(kmers, ref_w[0]) and np.array_equal(counts, ref_c),
            "counts differ from the numpy reference")
    log(f"[slice K={K}] equal to the numpy reference")

    head = chrom[:100_000]
    got = canonical_count_bytes(head, cfg, device="cuda")
    want = string_counter(head.tobytes().decode(), K)
    require(dict(zip(got[0].tolist(), got[1].tolist())) == want,
            "first 100 kb differ from the string Counter")
    log(f"[slice K={K}] first 100 kb equal to the string-level Counter ({len(want)} distinct)")
    _check_cli(chrom, K)
    return launches, (kmers, counts)


def phase_slice_mw(chrom: np.ndarray, smi: str):
    """The K > 31 path at K = 47 (K3, then K2 over run ids), plus K = 63 and
    K = 80 on a few hundred kb; returns the K = 47 run's launch counts."""
    import torch

    from kmers_tpu_torch import CountConfig, canonical_count_bytes
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit

    tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
    stream = importlib.import_module("kmers_tpu_torch.pipelines._stream")
    cfg = CountConfig(K=K_MW)
    L = chrom.size
    n_chunks = len(range(0, L - K_MW + 1, cfg.resolved_chunk_size - (K_MW - 1)))
    require(cfg.resolved_chunk_size == CHUNK_MW, "K > 31 chunk size")
    canonical_count_bytes(chrom[: 3 * CHUNK_MW], cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    canonical_words.launches = 0
    rle_unit.launches = 0
    merge_tables.launches = 0
    compact_table.launches = 0
    t0 = time.perf_counter()
    kmers, counts = canonical_count_bytes(chrom, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {"canonical_words": canonical_words.launches, "rle_unit": rle_unit.launches,
                "merge_tables": merge_tables.launches, "compact_table": compact_table.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice K={K_MW}] {L} bases, {n_chunks} chunks of 2^19: {wall:.3f} s wall, "
        f"{L / wall:.0f} bases/s, {kmers.size} distinct, {int(counts.sum())} counted, "
        f"peak device memory {peak} bytes ({smi})")
    log(f"[slice K={K_MW}] launches during the run: {launches}")
    require_fold_launches(launches, n_chunks, merges=False)
    require(kmers.dtype == object and counts.dtype == np.int64, "K=47 output dtypes")

    # where the time goes: synchronising timers around each stage of one
    # call (the device is busy ~4 % of a K = 47 call: PERF.md section 5)
    stages = ["canonical_words", "sort_count_mw", "compact_counts", "merge_compact_tables_mw",
              "words_to_ints"]
    t0 = time.perf_counter()
    # the chunk loop's compaction lives in the shared _stream module
    targets = [(stream if name == "compact_counts" else tcc, name) for name in stages]
    with stage_timers(targets) as secs:
        canonical_count_bytes(chrom, cfg, device="cuda")
    staged = time.perf_counter() - t0
    rest = staged - sum(secs.values())
    log(f"[slice K={K_MW}] stages (synchronised timers, {staged:.3f} s in all): "
        + ", ".join(f"{name} {secs[name]:.3f} s" for name in stages)
        + f", rest (upload, drain, mask, download) {rest:.3f} s")
    log(f"[slice K={K_MW}] turning words into Python ints: {secs['words_to_ints']:.3f} s")

    t0 = time.perf_counter()
    ref_w, ref_c = numpy_reference(chrom, K_MW)
    log(f"[slice K={K_MW}] numpy reference in {time.perf_counter() - t0:.1f} s: {ref_c.size} distinct")
    t0 = time.perf_counter()
    ref_k = join_words(ref_w)
    require(np.array_equal(counts, ref_c) and np.array_equal(kmers, ref_k),
            "K=47 counts differ from the numpy reference")
    log(f"[slice K={K_MW}] equal to the numpy reference (joined and compared in "
        f"{time.perf_counter() - t0:.1f} s)")
    del ref_w, ref_k, kmers, counts

    head = chrom[:100_000]
    got = canonical_count_bytes(head, cfg, device="cuda")
    want = string_counter(head.tobytes().decode(), K_MW)
    require(dict(zip(got[0].tolist(), got[1].tolist())) == want,
            "K=47: first 100 kb differ from the string Counter")
    log(f"[slice K={K_MW}] first 100 kb equal to the string-level Counter ({len(want)} distinct)")
    _check_cli(chrom, K_MW)

    part = chrom[L // 3 - 100_000 : L // 3 + 200_000]  # ends in the poly-A/tandem region
    for k in (63, 80):
        before = canonical_words.launches
        got = canonical_count_bytes(part, CountConfig(K=k), device="cuda")
        ref_w, ref_c = numpy_reference(part, k)
        require(np.array_equal(got[1], ref_c) and np.array_equal(got[0], join_words(ref_w)),
                f"K={k} differs from the numpy reference")
        route = "K3" if canonical_words.launches > before else "plain windows"
        require((route == "K3") == (k <= 63), f"K={k} took {route}")
        log(f"[slice K={k}] {part.size} bases equal to the numpy reference through {route} "
            f"({ref_c.size} distinct, max count {int(ref_c.max())})")
    return launches


def _fasta(path: Path, records) -> None:
    path.write_bytes(b"".join(b">r%d\n%s\n" % (i, r.tobytes()) for i, r in enumerate(records)))


def _cli_run(*args) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "kmers_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, f"CLI {args[0]} failed: {proc.stderr[-2000:]}")
    return proc


def _cli(*args) -> str:
    return _cli_run(*args).stdout


def _log_profile(tag: str, fn, smi: str, reps: int = 3, warm: bool = True) -> None:
    """Log the per-call ``torch.profiler`` breakdown of ``reps`` calls
    (after one untimed call, with ``warm``)."""
    p_wall, busy, categories, per_name = device_profile(fn, reps, warm=warm)
    log(f"[{tag}] profile of {reps} calls: {p_wall:.4f} s wall a call, device busy {busy:.4f} s "
        f"({100 * busy / p_wall:.1f} % of the call; {smi})")
    for cat, secs in categories.most_common():
        log(f"[{tag}]   {cat}: {1e3 * secs:.3f} ms device time a call")
    for name, (calls, secs) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"[{tag}]   kernel {name[:90]}: {calls:g} calls, {1e3 * secs:.3f} ms a call")


def phase_sketch_extract(chrom: np.ndarray, smi: str):
    """MinHash at K = 21 (K1's hash mode) through both selection routes,
    and extraction at K = 31 and minimizers at K = 15, W = 10 (K6) on the
    whole chromosome, each against numpy; the streamed sketch, the CLI's
    sketch and dist, and K = 32; returns the launch counts of the main
    runs, summed."""
    import torch

    from kmers_tpu_torch import extract_kmers, minhash_sketch, minimizer_select, sketch_fastx_stream
    from kmers_tpu_torch.ops.kernels.general_kernel import windows_general, windows_k32
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_hashes
    from kmers_tpu_torch.pipelines import join_records_with_n
    from kmers_tpu_torch.pipelines import minhash as minhash_module

    L = chrom.size
    launches = collections.Counter()
    # warm-up on 1 Mb (first use of torch's topk, unique, nonzero kernels)
    minhash_sketch(chrom[:CHUNK], K=K_SKETCH, s=S_SKETCH, device="cuda")
    extract_kmers(chrom[:CHUNK], K=K, device="cuda")
    minimizer_select(chrom[:CHUNK], K=15, W=10, skip_ambiguous=True, device="cuda")
    torch.cuda.synchronize()

    # 1. minhash.  The chromosome's 50 kb poly-A run puts 50,000 copies of
    # one hash in the 4 s-key prefix, so its sketch takes the full-width
    # fallback; without the poly-A/tandem region the prefix is exact.
    # ``minhash._smallest`` runs once on the exact route, twice on the
    # fallback.
    def sketch_route(seq):
        calls = []
        smallest = minhash_module._smallest
        minhash_module._smallest = lambda *a: calls.append(1) or smallest(*a)
        try:
            canonical_hashes.launches = 0
            t0 = time.perf_counter()
            sk = minhash_sketch(seq, K=K_SKETCH, s=S_SKETCH, device="cuda")
            wall = time.perf_counter() - t0
        finally:
            minhash_module._smallest = smallest
        launches["canonical_hashes"] += canonical_hashes.launches
        require(canonical_hashes.launches >= 1, "minhash did not launch K1's hash mode")
        return sk, wall, {1: "exact prefix", 2: "full-width fallback"}[len(calls)]

    tr = L // 3
    clean = np.concatenate([chrom[:tr], chrom[tr + 100_000 :]])
    for tag, seq, want_route in [("sketch", chrom, "full-width fallback"),
                                 ("sketch-exact", clean, "exact prefix")]:
        sketch, wall, route = sketch_route(seq)
        log(f"[{tag}] minhash_sketch K={K_SKETCH} s={S_SKETCH} on {seq.size} bases: {wall:.4f} s wall, "
            f"{seq.size / wall:.0f} bases/s, {route}, canonical_hashes launches "
            f"{canonical_hashes.launches} ({smi})")
        require(route == want_route, f"{tag} took the {route}, not the {want_route}")
        _log_profile(tag, lambda: minhash_sketch(seq, K=K_SKETCH, s=S_SKETCH, device="cuda"), smi)
        t0 = time.perf_counter()
        want = numpy_sketch(seq, K_SKETCH, S_SKETCH)
        require(sketch.dtype == np.uint64 and np.array_equal(sketch, want),
                f"{tag}: minhash sketch differs from the numpy reference")
        log(f"[{tag}] equal to the numpy sketch ({want.size} hashes; reference in "
            f"{time.perf_counter() - t0:.1f} s)")
    del clean, seq

    # 2. extraction of every forward 31-mer
    windows_general.launches = 0
    t0 = time.perf_counter()
    vals, pos = extract_kmers(chrom, K=K, canonical=False, device="cuda")
    wall = time.perf_counter() - t0
    launches["windows_general"] += windows_general.launches
    log(f"[extract] extract_kmers K={K} on {L} bases: {wall:.4f} s wall, {L / wall:.0f} bases/s, "
        f"{vals.size} k-mers, windows_general launches {windows_general.launches} ({smi})")
    require(windows_general.launches == 1, "extract_kmers did not launch K6 once")
    _log_profile("extract", lambda: extract_kmers(chrom, K=K, canonical=False, device="cuda"), smi)
    fw, can, valid = numpy_windows(chrom, K)
    require(vals.dtype == np.uint64 and np.array_equal(vals, fw[valid]), "extracted values differ from numpy")
    require(np.array_equal(pos, np.flatnonzero(valid)), "extracted positions differ from numpy")
    log("[extract] values and positions equal to numpy")
    del vals, pos, fw, can, valid

    # 2b. every 32-mer: K8b, the registers and a validity plane (no sentinel
    # fits a 64-bit register)
    t0 = time.perf_counter()
    fw, can, valid = numpy_windows(chrom, 32)
    ref_s = time.perf_counter() - t0
    for canonical in (False, True):
        windows_k32.launches = 0
        t0 = time.perf_counter()
        vals, pos = extract_kmers(chrom, K=32, canonical=canonical, device="cuda")
        wall = time.perf_counter() - t0
        require(windows_k32.launches == 1, f"extract_kmers K=32 launched K8b {windows_k32.launches} times")
        launches["windows_k32"] += windows_k32.launches
        require(vals.dtype == np.uint64 and np.array_equal(vals, (can if canonical else fw)[valid])
                and np.array_equal(pos, np.flatnonzero(valid)),
                f"K=32 extraction (canonical={canonical}) differs from numpy")
        log(f"[extract] extract_kmers K=32 canonical={canonical} on {L} bases: {wall:.4f} s wall, "
            f"{vals.size} k-mers ({int((vals >> np.uint64(63)).sum())} with the top bit set), "
            f"windows_k32 launches 1; values and positions equal to numpy (reference in {ref_s:.1f} s; "
            f"{smi})")
    del vals, pos, fw, can, valid

    # 3. minimizers (minimap2's k and w)
    windows_general.launches = 0
    t0 = time.perf_counter()
    mvals, mpos = minimizer_select(chrom, K=15, W=10, canonical=True, skip_ambiguous=True, device="cuda")
    wall = time.perf_counter() - t0
    launches["windows_general"] += windows_general.launches
    log(f"[minimizers] minimizer_select K=15 W=10 on {L} bases: {wall:.4f} s wall, "
        f"{L / wall:.0f} bases/s, {mvals.size} minimizers, windows_general launches "
        f"{windows_general.launches} ({smi})")
    require(windows_general.launches == 1, "minimizer_select did not launch K6 once")
    _log_profile("minimizers", lambda: minimizer_select(
        chrom, K=15, W=10, canonical=True, skip_ambiguous=True, device="cuda"), smi)
    t0 = time.perf_counter()
    _, can, valid = numpy_windows(chrom, 15)
    h = np.where(valid, can * FX, ALL_ONES)
    view = np.lib.stride_tricks.sliding_window_view(h, 10)
    arg = np.argmin(view, axis=1)
    win_pos = np.arange(arg.size) + arg  # leftmost argmin of each window
    # a window with no valid k-mer selects nothing; repeats are dropped
    keep = np.concatenate([[True], win_pos[1:] != win_pos[:-1]]) & (h[win_pos] != ALL_ONES)
    ref_pos = win_pos[keep]
    require(np.array_equal(mpos, ref_pos) and np.array_equal(mvals, can[ref_pos]),
            "minimizers differ from the numpy reference")
    log(f"[minimizers] equal to numpy (reference in {time.perf_counter() - t0:.1f} s)")
    del h, view, arg, win_pos, keep, can, valid, mvals, mpos

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 4. the streamed sketch of a 40-record FASTA
        rng = np.random.default_rng(3)
        starts = np.sort(rng.integers(0, L - 200_000, 40))
        records = [chrom[a : a + int(n)] for a, n in zip(starts, rng.integers(1_000, 200_000, 40))]
        fa = tmp / "records.fa"
        _fasta(fa, records)
        offsets = np.concatenate([[0], np.cumsum([r.size for r in records])])
        joined = join_records_with_n(np.concatenate(records), offsets)
        t0 = time.perf_counter()
        streamed = sketch_fastx_stream(fa, K=K_SKETCH, s=S_SKETCH, batch_bytes=1 << 20,
                                       chunk_size=1 << 20, device="cuda")
        wall = time.perf_counter() - t0
        require(np.array_equal(streamed, minhash_sketch(joined, K=K_SKETCH, s=S_SKETCH, device="cuda")),
                "streamed sketch differs from the one-shot sketch")
        log(f"[sketch] sketch_fastx_stream over 40 records ({joined.size} bases, batches of 1 MiB): "
            f"{wall:.4f} s, equal to the one-shot sketch")

        # 5. the CLI on two overlapping 2 Mb FASTAs
        a, b = chrom[5_000_000:7_000_000], chrom[6_000_000:8_000_000]
        _fasta(tmp / "a.fa", [a])
        _fasta(tmp / "b.fa", [b])
        (tmp / "a.sk").write_text(_cli("sketch", str(tmp / "a.fa"), "-k", "21", "-s", "1000"))
        (tmp / "b.sk").write_text(_cli("sketch", str(tmp / "b.fa"), "-k", "21", "-s", "1000"))
        want_j = numpy_jaccard(numpy_sketch(a, 21, 1000), numpy_sketch(b, 21, 1000))
        for x, y in [("a.sk", "b.sk"), ("a.fa", "b.fa")]:
            got = json.loads(_cli("dist", str(tmp / x), str(tmp / y), "-k", "21", "-s", "1000"))
            require(got["jaccard"] == round(want_j, 6), f"CLI dist {got} != numpy jaccard {want_j}")
        log(f"[cli] sketch and dist on two 2 Mb FASTAs: {got}, numpy jaccard {want_j:.6f}")

    # 6. K = 32 on 300 kb: minhash through plain torch, extraction through K8b
    part = chrom[L // 3 - 200_000 : L // 3 + 100_000]
    before = canonical_hashes.launches, windows_general.launches, windows_k32.launches
    sk32 = minhash_sketch(part, K=32, s=S_SKETCH, device="cuda")
    vals, pos = extract_kmers(part, K=32, canonical=True, device="cuda")
    after = canonical_hashes.launches, windows_general.launches, windows_k32.launches
    require(after == (before[0], before[1], before[2] + 1), f"K=32 launches {before} -> {after}")
    _, can, valid = numpy_windows(part, 32)
    require(np.array_equal(sk32, numpy_sketch(part, 32, S_SKETCH)), "K=32 sketch differs from numpy")
    require(np.array_equal(vals, can[valid]) and np.array_equal(pos, np.flatnonzero(valid)),
            "K=32 extraction differs from numpy")
    log(f"[k=32] minhash (plain torch) and canonical extraction (K8b) on {part.size} bases equal to "
        f"numpy ({vals.size} k-mers)")
    return launches


def phase_sixframe(chrom: np.ndarray, smi: str):
    """Six-frame amino-acid counting: K = 7 on the whole chromosome (K4,
    sort, K2), K = 15 on 8 Mb (K5, the word path), K = 8 and 32 on 1 Mb,
    each against the numpy reference; the CLI.  Returns the launch counts
    of the K = 7 and K = 15 runs, summed, and the K = 7 table."""
    import torch

    from kmers_tpu_torch import SixFrameCountConfig, sixframe_aa_count
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit
    from kmers_tpu_torch.ops.kernels.sixframe_kernel import sixframe_windows, sixframe_words

    tbl = codon_table_from_ncbi(NCBI_STANDARD)
    L = chrom.size
    launches = collections.Counter()
    cfg = SixFrameCountConfig(K=K_AA)
    n_chunks = len(range(0, L - 3 * K_AA + 1, cfg.chunk_size - (3 * K_AA - 1)))
    sixframe_aa_count(chrom[: 3 * CHUNK], cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    sixframe_windows.launches = 0
    rle_unit.launches = 0
    merge_tables.launches = 0
    compact_table.launches = 0
    t0 = time.perf_counter()
    kmers, counts = sixframe_aa_count(chrom, cfg, device="cuda")
    wall = time.perf_counter() - t0
    run = {"sixframe_windows": sixframe_windows.launches, "rle_unit": rle_unit.launches,
           "merge_tables": merge_tables.launches, "compact_table": compact_table.launches}
    launches.update(run)
    peak = torch.cuda.max_memory_allocated()
    total = int(counts.sum())
    log(f"[sixframe K={K_AA}] {L} bases, {n_chunks} chunks of 2^20: {wall:.3f} s wall, "
        f"{total / wall:.0f} amino-acid windows/s, {L / wall:.0f} bases/s, {kmers.size} distinct, "
        f"{total} counted, peak device memory {peak} bytes ({smi})")
    log(f"[sixframe K={K_AA}] launches during the run: {run}")
    require_fold_launches(run, n_chunks, merges=True)
    require(kmers.dtype == np.uint64 and counts.dtype == np.int64, "six-frame output dtypes")
    log_fold(f"sixframe K={K_AA}", lambda: sixframe_aa_count(chrom, cfg, device="cuda"),
             importlib.import_module("kmers_tpu_torch.pipelines.sixframe"), smi)
    _log_profile(f"sixframe K={K_AA}", lambda: sixframe_aa_count(chrom, cfg, device="cuda"), smi, reps=1)

    t0 = time.perf_counter()
    ref_l, ref_c = numpy_sixframe(chrom, K_AA, tbl)
    log(f"[sixframe K={K_AA}] numpy reference in {time.perf_counter() - t0:.1f} s: {ref_c.size} distinct")
    require(np.array_equal(kmers, ref_l[0]) and np.array_equal(counts, ref_c),
            "six-frame counts differ from the numpy reference")
    log(f"[sixframe K={K_AA}] equal to the numpy reference")
    del ref_l, ref_c

    head = chrom[:100_000]
    got = sixframe_aa_count(head, cfg, device="cuda")
    want = string_sixframe_counter(head.tobytes().decode(), K_AA)
    require(dict(zip(got[0].tolist(), got[1].tolist())) == want,
            "six-frame: first 100 kb differ from the string Counter")
    log(f"[sixframe K={K_AA}] first 100 kb equal to the string-level Counter ({len(want)} distinct)")

    # the word path: K5, sort_count_mw, merges of word tables, Python ints
    for k, part in [(K_AA_MW, chrom[: 8 * CHUNK]), (8, chrom[L // 3 - CHUNK // 2 : L // 3 + CHUNK // 2]),
                    (32, chrom[5 * CHUNK : 6 * CHUNK])]:
        sixframe_words.launches = 0
        rle_unit.launches = 0
        merge_tables.launches = 0
        compact_table.launches = 0
        t0 = time.perf_counter()
        got = sixframe_aa_count(part, SixFrameCountConfig(K=k), device="cuda")
        wall = time.perf_counter() - t0
        run = {"sixframe_words": sixframe_words.launches, "rle_unit": rle_unit.launches,
               "merge_tables": merge_tables.launches, "compact_table": compact_table.launches}
        chunks = len(range(0, part.size - 3 * k + 1, cfg.chunk_size - (3 * k - 1)))
        require_fold_launches(run, chunks, merges=False)
        if k == K_AA_MW:
            launches.update(run)
            _log_profile(f"sixframe K={k}", lambda: sixframe_aa_count(part, SixFrameCountConfig(K=k),
                                                                      device="cuda"), smi, reps=1)
        ref_l, ref_c = numpy_sixframe(part, k, tbl)
        require(got[0].dtype == object and np.array_equal(got[1], ref_c)
                and got[0].tolist() == join_limbs(ref_l).tolist(),
                f"six-frame K={k} differs from the numpy reference")
        log(f"[sixframe K={k}] {part.size} bases in {wall:.3f} s ({int(got[1].sum()) / wall:.0f} "
            f"amino-acid windows/s), launches {run}: equal to the numpy reference "
            f"({ref_c.size} distinct, max count {int(ref_c.max())})")

    records = [chrom[200_000:220_000], chrom[500_000:501_000], chrom[L // 2 - 10_000 : L // 2 + 10_000]]
    want = collections.Counter()
    for r in records:
        want.update(string_sixframe_counter(r.tobytes().decode(), K_AA))
    with tempfile.TemporaryDirectory() as tmp:
        fa = Path(tmp) / "reads.fa"
        _fasta(fa, records)
        totals = json.loads(_cli("sixframe", str(fa), "-k", str(K_AA)))
    require(totals == {"distinct": len(want), "total": sum(want.values())},
            f"CLI sixframe totals {totals}")
    log(f"[sixframe K={K_AA}] CLI on a 3-record FASTA: {totals}, equal to the string counter")
    return launches, (kmers, counts)


def sample_reads(chrom: np.ndarray, n: int, length: int, seed: int) -> np.ndarray:
    """``(n, length)`` reads at random positions of ``chrom``, half of them
    reverse-complemented (ACGT and acgt complemented, other bytes kept)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, chrom.size - length, n)
    reads = np.lib.stride_tricks.sliding_window_view(chrom, length)[starts]
    comp = np.arange(256, dtype=np.uint8)
    for a, b in (b"AT", b"TA", b"CG", b"GC", b"at", b"ta", b"cg", b"gc"):
        comp[a] = b
    rc = rng.random(n) < 0.5
    reads[rc] = comp[reads[rc][:, ::-1]]
    return reads


def write_fastq(path: Path, reads: np.ndarray) -> None:
    """One 4-line FASTQ record a read (fixed-width headers, quality 'I')."""
    n, length = reads.shape
    head = np.frombuffer(b"".join(b"@r%08d\n" % i for i in range(n)), np.uint8).reshape(n, 11)
    rows = np.concatenate([head, reads, np.full((n, 1), ord("\n"), np.uint8),
                           np.frombuffer(b"+\n", np.uint8)[None].repeat(n, 0),
                           np.full((n, length), ord("I"), np.uint8),
                           np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    path.write_bytes(rows.tobytes())


def phase_bench(smi: str) -> dict:
    """The ``bench`` path in this process: K1 and K2 against their plain
    versions at its shape (one chunk of 2^26 bytes), ``bench`` run with the
    launch counts from 0 (one warm-up and three timed calls: 4 of K1 and of
    K2), and the distinct count of each of its calls against numpy; returns
    the run's launch counts."""
    import torch

    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows, canonical_windows_plain

    cc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
    data = cc.bench_input()
    buf = torch.from_numpy(data).to("cuda")
    got = canonical_windows(buf, K)
    want = canonical_windows_plain(buf, K)
    require(all(torch_equal(g, w) for g, w in zip(got, want)), "K1 != plain at the bench shape")
    keys = torch.sort(got[0]).values
    del got, want
    got = rle_unit(keys)
    want = rle_unit_plain(keys)
    require(all(torch_equal(g, w) for g, w in zip(got, want)), "K2 != plain at the bench shape")
    log(f"[bench] K1 and K2 bit-equal to plain on {data.size} bytes, K={K} (n_unique={int(got[2])})")
    del got, want, keys, buf

    # record the scalars of every chunk bench counts; the wrapper adds no
    # synchronisation
    scalars = []
    count_chunk = cc._count_chunk

    def spy(chunk, k, track):
        out = count_chunk(chunk, k, track)
        scalars.append(out[1])
        return out

    canonical_windows.launches = 0
    rle_unit.launches = 0
    cc._count_chunk = spy
    try:
        line = cc.bench(device="cuda")
    finally:
        cc._count_chunk = count_chunk
    launches = {"canonical_windows": canonical_windows.launches, "rle_unit": rle_unit.launches}
    require(launches == {"canonical_windows": 4, "rle_unit": 4}, f"bench launched {launches}")
    require(list(line) == ["metric", "value", "unit", "vs_baseline"] and line["value"] > 0,
            f"bench line {line}")
    t0 = time.perf_counter()
    _, ref_c = numpy_reference(data, K)
    runs = [s.tolist() for s in scalars]
    require(runs == [[ref_c.size, 0, 0]] * 4,
            f"bench's [n_unique, n_invalid, n_ambig] {runs}, numpy has {ref_c.size} distinct")
    log(f"[bench] in process: {json.dumps(line)}, launches {launches}; each call's distinct count "
        f"{ref_c.size} equal to numpy (reference in {time.perf_counter() - t0:.1f} s; {smi})")
    return launches


def stream_host_split(fq: Path, cfg, smi: str) -> None:
    """Streamed counting of ``fq`` with the native and with the pure-Python
    parse: each call's host time split by stage with (non-synchronising)
    timers: the parse (``read_fastx_bytes`` inside ``stream_fastx``), the
    N-join, the upload, and the drain of each chunk (the one wait for its
    scalars, then its compaction and the level stack's merges enqueued); then
    the device's busy share of another call under the profiler.  The native
    scanner must be built."""
    from kmers_tpu_torch import count_fastx_stream
    from kmers_tpu_torch.io import native_available
    from kmers_tpu_torch.utils.streamq import DrainQueue

    require(native_available(), "the native FASTX scanner did not build")
    fasta = importlib.import_module("kmers_tpu_torch.io.fasta")
    streaming = importlib.import_module("kmers_tpu_torch.pipelines.streaming")
    stages = [(fasta, "read_fastx_bytes"), (streaming, "join_records_with_n"), (streaming, "upload"),
              (DrainQueue, "_drain_oldest")]
    label = {"read_fastx_bytes": "parse", "join_records_with_n": "N-join", "upload": "upload",
             "_drain_oldest": "drain (one sync a chunk)"}
    available = fasta.native_available

    def run():
        return count_fastx_stream(fq, cfg, batch_bytes=STREAM_BATCH, device="cuda")

    try:
        for route, native in (("native", True), ("pure-Python", False)):
            fasta.native_available = lambda: native
            t0 = time.perf_counter()
            with stage_timers(stages, sync=False) as secs:
                run()
            wall = time.perf_counter() - t0
            p_wall, busy, _, _ = device_profile(run)
            rest = wall - sum(secs.values())
            log(f"[stream] {route} parse: {wall:.3f} s wall, {READS / wall:.0f} reads/s; host time "
                + ", ".join(f"{label[name]} {secs[name]:.3f} s" for _, name in stages)
                + f", rest {rest:.3f} s; profiled call {p_wall:.3f} s, device busy {busy:.3f} s "
                f"({100 * busy / p_wall:.1f} %; {smi})")
    finally:
        fasta.native_available = available


def phase_stream(chrom: np.ndarray, smi: str):
    """Streamed counting of a FASTQ read set, the device merge of two
    halves' tables, the ``bench`` path and the CLI's ``count --stream``;
    returns the launch counts of the streamed run, the merge and ``bench``."""
    import torch

    from kmers_tpu_torch import CountConfig, canonical_count_records, count_fastx_stream, merge_counts_device
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows

    cfg = CountConfig(K=K)
    reads = sample_reads(chrom, READS, READ_LEN, seed=8)
    offsets = np.arange(0, READS * READ_LEN + 1, READ_LEN)
    # the records joined with N, as the pipelines join them
    joined = np.full((READS, READ_LEN + 1), ord("N"), np.uint8)
    joined[:, :READ_LEN] = reads
    joined = joined.reshape(-1)[:-1]
    with tempfile.TemporaryDirectory() as tmp:
        fq = Path(tmp) / "reads.fq"
        write_fastq(fq, reads)
        size = fq.stat().st_size
        kernels = (canonical_windows, rle_unit, merge_tables, compact_table)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        kmers, counts = count_fastx_stream(fq, cfg, batch_bytes=STREAM_BATCH, device="cuda")
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        log(f"[stream] count_fastx_stream K={K} over {READS} reads of {READ_LEN} bp ({size} bytes of "
            f"FASTQ, batches of {STREAM_BATCH} bytes): {wall:.3f} s wall, {READS / wall:.0f} reads/s, "
            f"{READS * READ_LEN / wall:.0f} bases/s, {kmers.size} distinct, {int(counts.sum())} counted "
            f"({smi})")
        log(f"[stream] launches during the run: {launches}")
        n_chunks = launches["canonical_windows"]
        require(n_chunks >= -(-joined.size // CHUNK), f"streamed run took {n_chunks} chunks")
        require_fold_launches(launches, n_chunks, merges=True)
        _log_profile("stream", lambda: count_fastx_stream(fq, cfg, batch_bytes=STREAM_BATCH, device="cuda"),
                     smi, reps=1, warm=False)
        stream_host_split(fq, cfg, smi)
    t0 = time.perf_counter()
    ref_w, ref_c = numpy_reference(joined, K)
    log(f"[stream] numpy reference of the joined records in {time.perf_counter() - t0:.1f} s: "
        f"{ref_c.size} distinct")
    require(np.array_equal(kmers, ref_w[0]) and np.array_equal(counts, ref_c),
            "streamed counts differ from the numpy reference")
    del ref_w, ref_c, joined
    whole = canonical_count_records(reads.reshape(-1), offsets, cfg, device="cuda")
    require(np.array_equal(kmers, whole[0]) and np.array_equal(counts, whole[1]),
            "streamed counts differ from canonical_count_records")
    log("[stream] equal to the numpy reference and to canonical_count_records on the card")

    # the device merge of the two halves' tables: records never share a
    # window, so it is the table of all the reads
    half = READS // 2
    a = canonical_count_records(reads[:half].reshape(-1), offsets[: half + 1], cfg, device="cuda")
    b = canonical_count_records(reads[half:].reshape(-1), offsets[: half + 1], cfg, device="cuda")
    merge_counts_device(*a, *b, device="cuda")  # warm-up
    count_ops = importlib.import_module("kmers_tpu_torch.ops.count")
    merge_tables.launches = 0
    compact_table.launches = 0
    t0 = time.perf_counter()
    with stream_timers([(count_ops, "merge_tables"), (count_ops, "compact_table")]) as fold:
        merged = merge_counts_device(*a, *b, device="cuda")
    m_wall = time.perf_counter() - t0
    m_launches = {"merge_tables": merge_tables.launches, "compact_table": compact_table.launches}
    require(m_launches == {"merge_tables": 1, "compact_table": 1},
            f"merge_counts_device launched {m_launches}, not one K9 and one K10")
    require(np.array_equal(merged[0], kmers) and np.array_equal(merged[1], counts),
            "merge_counts_device of the halves differs from the whole table")
    k9_ms, k10_ms = fold["merge_tables"][1], fold["compact_table"][1]
    log(f"[tables] merge_counts_device of {a[0].size} + {b[0].size} rows: {1e3 * m_wall:.3f} ms wall "
        f"(upload, fold, download), K9 {k9_ms:.3f} ms ({100 * k9_ms / 1e3 / m_wall:.2f} % of it), "
        f"K10 {k10_ms:.3f} ms (CUDA events), launches {m_launches}; equal to the table of all reads "
        f"({smi})")
    _log_profile("tables", lambda: merge_counts_device(*a, *b, device="cuda"), smi)
    del a, b, merged, whole, reads
    bench_launches = phase_bench(smi)

    # the CLI's bench command, as a user runs it
    line = json.loads(_cli("bench").strip().splitlines()[-1])
    require(list(line) == ["metric", "value", "unit", "vs_baseline"]
            and line["metric"] == "canonical_31mer_count_bases_per_sec_per_chip" and line["value"] > 0,
            f"bench line {line}")
    log(f"[bench] {json.dumps(line)} ({smi})")

    # the CLI's count --stream on three records (the last one crosses into
    # the poly-A run, so the top counts exceed 1)
    L = chrom.size
    records = [chrom[200_000:220_000], chrom[L // 2 - 10_000 : L // 2 + 10_000], chrom[L // 3 - 1000 : L // 3 + 1000]]
    want = collections.Counter()
    for r in records:
        want.update(string_counter(r.tobytes().decode(), K))
    with tempfile.TemporaryDirectory() as tmp:
        fq = Path(tmp) / "three.fq"
        fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * r.size)
                                for i, r in enumerate(records)))
        proc = _cli_run("count", str(fq), "-k", str(K), "--stream", "--top", "3")
    totals = json.loads(proc.stderr.strip().splitlines()[-1])
    require(totals == {"distinct": len(want), "total": sum(want.values())}, f"CLI count --stream totals {totals}")
    digits = str.maketrans("ACGT", "0123")
    top = [line.split("\t") for line in proc.stdout.strip().splitlines()]
    require(len(top) == 3 and all(want[int(kmer.translate(digits), 4)] == int(c) for kmer, c in top)
            and [int(c) for _, c in top] == sorted(want.values(), reverse=True)[:3],
            f"CLI count --stream top lines {top}")
    log(f"[stream] CLI count --stream on a 3-record FASTQ: {totals}, equal to the string counter")
    return collections.Counter(launches) + collections.Counter(m_launches) + collections.Counter(bench_launches)


def phase_sort(chrom: np.ndarray, smi: str) -> dict:
    """The sort-wall probe on this card: K1's keys of one 2^20 chunk and of
    ``bench``'s 2^26-byte chunk sorted by K11 in place of ``torch.sort``
    before K2, bit-equal to the default route (``sort_count``: ``torch.sort``
    and K2); both routes' times; returns K11's launches in the probe."""
    import torch

    from kmers_tpu_torch.ops import bitonic_local_sort, bitonic_sort, sort_count
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows

    cc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
    shapes = {"one 2^20 chunk": chrom[:CHUNK], "bench's 2^26-byte chunk": cc.bench_input()}
    keys = {name: canonical_windows(torch.from_numpy(data).to("cuda"), K)[0]
            for name, data in shapes.items()}

    def probe(k):
        return rle_unit(bitonic_sort(k))

    bitonic_sort.launches = 0
    bitonic_local_sort.launches = 0
    for name, k in keys.items():
        got, want = probe(k), sort_count(k)
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"K1 -> K11 -> K2 differs from K1 -> torch.sort -> K2 on {name}")
    launches = {"bitonic_sort": bitonic_sort.launches, "bitonic_local_sort": bitonic_local_sort.launches}
    require(launches == {"bitonic_sort": len(keys), "bitonic_local_sort": len(keys)},
            f"the probe launched K11 {launches}")
    for name, k in keys.items():
        n_unique = int(probe(k)[2])
        probe_ms = median_ms(lambda: probe(k), reps=10)
        default_ms = median_ms(lambda: sort_count(k), reps=10)
        _, _, _, per_name = device_profile(lambda: bitonic_sort(k), reps=2, warm=True)
        log(f"[sort] probe on {name} ({k.numel()} keys, {n_unique} distinct): K1 keys -> K11 -> K2 "
            f"{probe_ms:.4f} ms, K1 keys -> torch.sort -> K2 {default_ms:.4f} ms (CUDA events), "
            f"bit-equal; K11 device time {per_launch(per_name, 'k11_')} ({smi})")
    log(f"[sort] launches during the probe: {launches}")
    return launches


def phase_checkpoint(chrom: np.ndarray, smi: str) -> dict:
    """Count-table checkpoints: the CLI's ``count -k 31 -o`` of the
    chromosome loaded back equal to ``canonical_count_bytes``; ``merge`` of
    the two halves' checkpoints in process (one K9 and one K10 launch) equal
    to the table of the halves as two records; ``verify`` exiting 0, and 1
    after one byte of the input changed; a K = 47 round trip on 300 kb.
    Returns the merge's launches."""
    import io as std_io

    from kmers_tpu_torch import CountConfig, canonical_count_bytes, canonical_count_records
    from kmers_tpu_torch.__main__ import main as cli_main
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.utils import load_count_table, save_count_table

    def in_process(*args) -> dict:
        out = std_io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(list(args))
        return json.loads(out.getvalue().strip().splitlines()[-1])

    def verify(path) -> tuple:
        """The CLI's ``verify`` in process: its exit code and its line."""
        out = std_io.StringIO()
        code = 0
        with contextlib.redirect_stdout(out):
            try:
                cli_main(["verify", str(path)])
            except SystemExit as e:
                code = e.code
        return code, json.loads(out.getvalue().strip().splitlines()[-1])

    cfg = CountConfig(K=K)
    L = chrom.size
    half = L // 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fa = tmp / "chrom.fa"
        _fasta(fa, [chrom])
        t0 = time.perf_counter()
        line = json.loads(_cli("count", str(fa), "-k", str(K), "-o", str(tmp / "whole")).strip().splitlines()[-1])
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        kmers, counts, k = load_count_table(tmp / "whole")
        load_s = time.perf_counter() - t0
        want = canonical_count_bytes(chrom, cfg, device="cuda")
        require(k == K and np.array_equal(kmers, want[0]) and np.array_equal(counts, want[1]),
                "the checkpoint of count -o differs from canonical_count_bytes")
        require(line == {"distinct": int(want[0].size), "total": int(want[1].sum()), "output": str(tmp / "whole")},
                f"count -o printed {line}")
        size = sum(p.stat().st_size for p in (tmp / "whole").iterdir())
        log(f"[checkpoint] python -m kmers_tpu_torch count -k {K} -o on the chromosome: {wall:.3f} s "
            f"(process start, parse, count, write of {size} bytes), loaded back in {load_s:.3f} s equal to "
            f"canonical_count_bytes ({kmers.size} distinct)")
        del kmers, counts, want

        _fasta(tmp / "a.fa", [chrom[:half]])
        _fasta(tmp / "b.fa", [chrom[half:]])
        for part in ("a", "b"):
            in_process("count", str(tmp / f"{part}.fa"), "-k", str(K), "-o", str(tmp / part))
        merge_tables.launches = 0
        compact_table.launches = 0
        t0 = time.perf_counter()
        line = in_process("merge", str(tmp / "a"), str(tmp / "b"), "-o", str(tmp / "merged"))
        wall = time.perf_counter() - t0
        launches = {"merge_tables": merge_tables.launches, "compact_table": compact_table.launches}
        require(launches == {"merge_tables": 1, "compact_table": 1},
                f"merge launched {launches}, not one K9 and one K10")
        kmers, counts, k = load_count_table(tmp / "merged")
        want = canonical_count_records(chrom, np.array([0, half, L]), cfg, device="cuda")
        require(k == K and np.array_equal(kmers, want[0]) and np.array_equal(counts, want[1]),
                "the merge of the halves' checkpoints differs from the table of the halves")
        require(line["total"] == int(want[1].sum()) and line["distinct"] == int(want[0].size),
                f"merge printed {line}")
        log(f"[checkpoint] merge of the halves' checkpoints in process: {wall:.3f} s (load, K9 and K10 "
            f"on the card, write), launches {launches}; equal to the table of the halves as two records "
            f"({kmers.size} distinct, spectrum {line['spectrum_1_to_8plus']}; {smi})")
        del kmers, counts, want

        rc, report = verify(tmp / "whole")
        require(rc == 0 and report["ok"] and report["inputs_checked"] == 1, f"verify: exit {rc}, {report}")
        data = bytearray(fa.read_bytes())
        data[-2] = ord("C") if data[-2] != ord("C") else ord("G")
        fa.write_bytes(bytes(data))
        rc_changed, report = verify(tmp / "whole")
        require(rc_changed == 1 and not report["ok"] and report["inputs_changed"],
                f"verify after a changed byte: exit {rc_changed}, {report}")
        log(f"[checkpoint] verify: exit {rc} on the input as counted, exit {rc_changed} after one changed byte")

        part = chrom[L // 3 - 200_000 : L // 3 + 100_000]
        k47 = canonical_count_bytes(part, CountConfig(K=K_MW), device="cuda")
        save_count_table(tmp / "k47", *k47, K=K_MW)
        back = load_count_table(tmp / "k47")
        require(back[2] == K_MW and back[0].tolist() == k47[0].tolist() and np.array_equal(back[1], k47[1]),
                "the K = 47 checkpoint round trip differs")
        log(f"[checkpoint] K={K_MW} round trip on {part.size} bases: {k47[0].size} distinct, equal")
    return launches


# ---------------------------------------------------------------- parallel


PARALLEL_RANKS = 4
MW_SLICE = 4_000_000


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def capture_exchanges(module, name: str):
    """Record each call of ``module.<name>`` (an exchange: ``(tables, mesh,
    cap, ...)`` -> ``(merged, overflow)``) as a dict of its inputs and
    outputs; restores the function on exit."""
    calls = []
    real = getattr(module, name)

    def spy(tables, mesh, cap, *args):
        merged, overflow = real(tables, mesh, cap, *args)
        calls.append({"tables": tables, "mesh": mesh, "cap": cap, "args": args,
                      "merged": merged, "overflow": overflow})
        return merged, overflow

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _fold_geometry(n_ranks: int, L: int, k: int, chunk: int) -> dict:
    """K1, K2, K9 and K10 launches of a sharded K <= 31 count: per rank one
    K1 and one K2 a slab chunk; on the streamed route one K10 a chunk and,
    for each of the chunks - 1 merges of the level stack, one K9 and one
    K10.  A slab of one chunk is counted in one dispatch and not folded."""
    shard = -(-L // n_ranks)
    steps = len(range(0, shard, chunk - (k - 1))) if -(-shard // chunk) > 1 else 1
    return {"canonical_windows": n_ranks * steps, "rle_unit": n_ranks * steps,
            "merge_tables": n_ranks * (steps - 1),
            "compact_table": n_ranks * (2 * steps - 1) if steps > 1 else 0}


def phase_parallel(chrom: np.ndarray, smi: str, table_31) -> collections.Counter:
    """The parallel plane: ``sharded_canonical_count`` at K = 31 on the
    whole chromosome over ``data_mesh(1)``, over 4 ranks on ``cuda:0`` and
    over an NCCL process group of one rank, each equal to the single-device
    table of phase 4 (itself equal to the numpy reference), with each
    rank's k-mers routed to it and the launches of K1, K2, K9 and K10 equal
    to the slab and chunk geometry; ``sharded_canonical_count_mw`` at
    K = 47 on 4 Mb over 4 ranks and over NCCL (K3 once a rank), and
    ``sharded_minimizer_select`` at K = 15, W = 10 over 4 ranks (K6 once a
    rank), each equal to the single-device result.  K1 and K2 are held
    against their plain versions on a rank's first slab chunk first.
    Returns the launches of the driven runs."""
    import torch
    import torch.distributed as dist

    from kmers_tpu_torch import CountConfig, canonical_count_bytes, minimizer_select
    from kmers_tpu_torch import parallel as par
    from kmers_tpu_torch.ops.hashing import fx_hash_u64
    from kmers_tpu_torch.ops.kernels.general_kernel import windows_general
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows, canonical_windows_plain

    pipe = importlib.import_module("kmers_tpu_torch.parallel.pipeline")
    pmw = importlib.import_module("kmers_tpu_torch.parallel.multiword")
    fold = {"canonical_windows": canonical_windows, "rle_unit": rle_unit,
            "merge_tables": merge_tables, "compact_table": compact_table}
    want_k, want_c = table_31
    L = chrom.size
    total = collections.Counter()

    # K1 and K2 against their plain versions on rank 1's first slab chunk,
    # cut to an odd length (not counted: the counts are reset before each run)
    rows, shard = pipe._shard_with_halo(chrom, PARALLEL_RANKS, K, ord("N"))
    view = torch.from_numpy(rows[1, : CHUNK - 1].copy()).to("cuda")
    del rows
    got = canonical_windows(view, K)
    want = canonical_windows_plain(view.cpu(), K)
    torch.cuda.synchronize()
    require(max_abs_err(got, want) == 0.0, "K1 differs from plain on a slab chunk")
    keys = torch.sort(got[0]).values
    require(max_abs_err(rle_unit(keys), rle_unit_plain(keys.cpu())) == 0.0,
            "K2 differs from plain on a slab chunk")
    log(f"[parallel] K1 and K2 equal to plain on rank 1's first slab chunk ({view.numel()} bytes, "
        f"shard {shard} bases)")
    del view, got, want, keys

    def count_31(tag: str, mesh) -> None:
        for fn in fold.values():
            fn.launches = 0
        cfg = par.ShardedCountConfig(K=K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_exchanges(pipe, "exchange_and_merge") as calls:
            kmers, counts = par.sharded_canonical_count(chrom, cfg, mesh)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fold.items()}
        total.update(launches)
        (call,) = calls
        log(f"[parallel K={K}] {tag}: {mesh.size} rank(s) {[str(d) for d in mesh.devices]}, "
            f"{wall:.3f} s wall, {L / wall:.0f} bases/s, cap {call['cap']}, overflow "
            f"{call['overflow']}, {kmers.size} distinct ({smi})")
        log(f"[parallel K={K}] {tag}: launches {launches}")
        want_launches = _fold_geometry(mesh.size, L, K, cfg.chunk_size)
        require(launches == want_launches, f"{tag}: launches {launches}, geometry gives {want_launches}")
        require(call["overflow"] == 0, f"{tag}: overflow")
        require(np.array_equal(kmers, want_k) and np.array_equal(counts, want_c),
                f"{tag}: differs from the single-device table")
        for rank, (keys, cnt, _) in zip(mesh.ranks, call["merged"]):
            real = keys[cnt > 0]
            require(bool((pipe.destination(fx_hash_u64(real), mesh.size) == rank).all()),
                    f"{tag}: rank {rank} holds k-mers it does not own")
        log(f"[parallel K={K}] {tag}: equal to the single-device table and the numpy reference; "
            f"each rank's k-mers route to it")
        if mesh.size > 1:
            rows_in = sum(int(c.numel()) for _, c in call["tables"])
            p_wall, busy, categories, _ = device_profile(
                lambda: pipe.exchange_and_merge(call["tables"], mesh, call["cap"]), warm=True)
            log(f"[parallel K={K}] {tag}: exchange of {rows_in} table rows ({mesh.size} x {mesh.size} "
                f"buckets of {call['cap']}): {1e3 * busy:.3f} ms device time, {1e3 * p_wall:.3f} ms "
                f"wall (torch.profiler; {smi})")
            for cat, secs in categories.most_common(6):
                log(f"[parallel K={K}] {tag}:   {cat}: {1e3 * secs:.3f} ms")

    part = chrom[L // 3 - MW_SLICE // 2 : L // 3 + MW_SLICE // 2]  # holds the poly-A region
    t0 = time.perf_counter()
    want_mw = canonical_count_bytes(part, CountConfig(K=K_MW), device="cuda")
    log(f"[parallel K={K_MW}] single device on {part.size} bases: {time.perf_counter() - t0:.3f} s")

    def count_mw(tag: str, mesh) -> None:
        canonical_words.launches = 0
        t0 = time.perf_counter()
        with capture_exchanges(pmw, "exchange_and_merge_mw") as calls:
            kmers, counts = par.sharded_canonical_count_mw(part, K=K_MW, mesh=mesh)
        wall = time.perf_counter() - t0
        (call,) = calls
        total["canonical_words"] += canonical_words.launches
        log(f"[parallel K={K_MW}] {tag}: {mesh.size} rank(s), {part.size} bases, {wall:.3f} s wall, "
            f"cap {call['cap']}, overflow {call['overflow']}, {kmers.size} distinct, K3 launches "
            f"{canonical_words.launches} ({smi})")
        require(canonical_words.launches == mesh.size, f"{tag}: K3 launched {canonical_words.launches} times")
        require(np.array_equal(counts, want_mw[1]) and np.array_equal(kmers, want_mw[0]),
                f"{tag}: K={K_MW} differs from the single-device table")

    four = par.Mesh(["cuda:0"] * PARALLEL_RANKS)
    # warm-up on 3 chunks' worth (first use of each torch kernel of the exchange)
    par.sharded_canonical_count(chrom[: 3 * CHUNK], par.ShardedCountConfig(K=K), four)
    count_31("data_mesh(1)", par.data_mesh(1))
    count_31(f"{PARALLEL_RANKS} ranks on cuda:0", four)
    count_mw(f"{PARALLEL_RANKS} ranks on cuda:0", four)

    # minimizers over 4 ranks against minimizer_select on one device
    want_min = minimizer_select(chrom, K=15, W=10, canonical=True, skip_ambiguous=True, device="cuda")
    windows_general.launches = 0
    t0 = time.perf_counter()
    vals, pos = par.sharded_minimizer_select(chrom, K=15, W=10, mesh=four, skip_ambiguous=True)
    wall = time.perf_counter() - t0
    total["windows_general"] += windows_general.launches
    log(f"[parallel minimizers] K=15 W=10 over {PARALLEL_RANKS} ranks: {wall:.3f} s wall, "
        f"{vals.size} minimizers, K6 launches {windows_general.launches} ({smi})")
    require(windows_general.launches == PARALLEL_RANKS, "sharded minimizers: K6 not once a rank")
    require(np.array_equal(vals, want_min[0]) and np.array_equal(pos, want_min[1]),
            "sharded minimizers differ from minimizer_select")

    # one rank a process: an NCCL group of one, built here and torn down
    # after; any failure to build it fails the run
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = par.data_mesh()
        require(mesh.group is not None and mesh.size == 1 and mesh.devices == (torch.device("cuda", 0),),
                f"NCCL mesh {mesh}")
        buckets = torch.arange(2 * 1000 * 2, device="cuda").reshape(1, 2000, 2)
        (back,) = mesh.all_to_all([buckets])
        require(torch.equal(back, buckets), "NCCL all_to_all of one rank is not the identity")
        require(mesh.sum([torch.tensor([3, 4])]) == [3, 4] and mesh.max([torch.tensor(5)]) == [5],
                "NCCL reductions")
        count_31("NCCL world size 1", mesh)
        count_mw("NCCL world size 1", mesh)
    finally:
        dist.destroy_process_group()
    return total


def _sixframe_geometry(n_ranks: int, L: int, k: int, chunk: int, words: bool) -> dict:
    """K4 (or K5), K2, K9 and K10 launches of a sharded six-frame count: a
    rank's slab of ``shard + 6k`` bytes streams in chunks that overlap by
    3k - 1, each one front-end and one K2 launch; more than one chunk adds
    one K10 a chunk and, for each of the chunks - 1 merges, one K10 and
    (one-word tables only) one K9."""
    shard = -(-L // n_ranks)
    shard += (-shard) % 3
    steps = len(range(0, shard + 3 * k + 1, chunk - (3 * k - 1)))
    front = "sixframe_words" if words else "sixframe_windows"
    return {front: n_ranks * steps, "rle_unit": n_ranks * steps,
            "merge_tables": 0 if words else n_ranks * (steps - 1),
            "compact_table": n_ranks * (2 * steps - 1) if steps > 1 else 0}


def phase_parallel_sixframe(chrom: np.ndarray, smi: str, table_7) -> collections.Counter:
    """Sharded six-frame counting (``sharded_sixframe_aa_count``): K = 7 on
    the whole chromosome over ``data_mesh(1)``, over 4 ranks on ``cuda:0``
    and over an NCCL process group of one rank, each equal to the
    single-device table of ``phase_sixframe`` (itself equal to the numpy
    reference); K = 12 (K5, two words) on 1 Mb over 4 ranks and over NCCL,
    equal to the single-device result and to numpy.  In each run every
    rank's k-mers route to it and the launches of K4 or K5, K2, K9 and K10
    equal the slab and chunk geometry.  K4 and K5 are held against their
    plain versions first, on a rank's first and last slab chunks with the
    rank's bounds; the CLI's ``sixframe`` runs on a 1 Mb FASTA.  Returns
    the launches of the driven runs."""
    import torch
    import torch.distributed as dist

    from kmers_tpu_torch import SixFrameCountConfig, sixframe_aa_count
    from kmers_tpu_torch import parallel as par
    from kmers_tpu_torch.ops.hashing import fx_hash_u64
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit
    from kmers_tpu_torch.ops.kernels.sixframe_kernel import (
        sixframe_windows,
        sixframe_windows_plain,
        sixframe_words,
        sixframe_words_plain,
    )
    from kmers_tpu_torch.ops.multiword import fx_hash_mw

    pipe = importlib.import_module("kmers_tpu_torch.parallel.pipeline")
    psix = importlib.import_module("kmers_tpu_torch.parallel.sixframe")
    fold = {"sixframe_windows": sixframe_windows, "sixframe_words": sixframe_words, "rle_unit": rle_unit,
            "merge_tables": merge_tables, "compact_table": compact_table}
    L = chrom.size
    part = chrom[L // 3 - CHUNK // 2 : L // 3 + CHUNK // 2]
    total = collections.Counter()

    # K4 and K5 against their plain versions on rank 1's first and last slab
    # chunks, with the rank's ownership bounds (not counted: the counts are
    # reset before each run)
    for k, seq, kernel, plain in ((K_AA, chrom, sixframe_windows, sixframe_windows_plain),
                                  (K_AA_WIDE, part, sixframe_words, sixframe_words_plain)):
        rows, shard = psix._sixframe_slabs(seq, PARALLEL_RANKS, k)
        H = 3 * k
        slab = rows[1]
        starts = range(0, slab.size - 3 * k + 1, CHUNK - (3 * k - 1))
        for start in sorted({starts[0], starts[-1]}):
            view = torch.from_numpy(slab[start : start + CHUNK].copy()).to("cuda")
            bounds = (H - start, H + shard - start, 1 - start, shard + 1 - start)
            got = kernel(view, k, bounds)
            want = plain(view.cpu(), k, bounds)
            torch.cuda.synchronize()
            require(max_abs_err(got, want) == 0.0, f"{kernel.__name__} differs from plain on a slab chunk at K={k}")
            log(f"[parallel sixframe K={k}] {kernel.__name__} equal to plain on rank 1's slab chunk at "
                f"{start} ({view.numel()} bytes, bounds {bounds}, {int(got[1])} windows emitted)")
        del rows, slab, view, got, want

    def run(tag: str, mesh, k: int, seq, want) -> None:
        for fn in fold.values():
            fn.launches = 0
        cfg = par.SixFrameCountConfig(K=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_exchanges(psix, "_exchange_tables") as calls:
            kmers, counts = par.sharded_sixframe_aa_count(seq, cfg, mesh)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fold.items()}
        total.update(launches)
        (call,) = calls
        windows = int(counts.sum())
        log(f"[parallel sixframe K={k}] {tag}: {mesh.size} rank(s) {[str(d) for d in mesh.devices]}, "
            f"{seq.size} bases, {wall:.3f} s wall, {windows / wall:.0f} amino-acid windows/s, cap "
            f"{call['cap']}, overflow {call['overflow']}, {kmers.size} distinct ({smi})")
        log(f"[parallel sixframe K={k}] {tag}: launches {launches}")
        want_launches = {name: 0 for name in fold}
        want_launches.update(_sixframe_geometry(mesh.size, seq.size, k, cfg.chunk_size, k > K_AA))
        require(launches == want_launches, f"{tag}: launches {launches}, geometry gives {want_launches}")
        require(call["overflow"] == 0, f"{tag}: overflow")
        require(kmers.dtype == want[0].dtype and counts.dtype == np.int64
                and np.array_equal(counts, want[1]) and np.array_equal(kmers, want[0]),
                f"{tag}: K={k} differs from the single-device table")
        for rank, (keys, cnt, _) in zip(mesh.ranks, call["merged"]):
            real = keys[..., cnt > 0]
            hashes = fx_hash_u64(real) if k <= K_AA else fx_hash_mw(real, k, bps=8)
            require(bool((pipe.destination(hashes, mesh.size) == rank).all()),
                    f"{tag}: rank {rank} holds k-mers it does not own")
        log(f"[parallel sixframe K={k}] {tag}: equal to the single-device table; each rank's k-mers "
            f"route to it")
        if mesh.size > 1:
            rows_in = sum(int(c.numel()) for _, c in call["tables"])
            p_wall, busy, categories, _ = device_profile(
                lambda: psix._exchange_tables(call["tables"], mesh, call["cap"], k), warm=True)
            log(f"[parallel sixframe K={k}] {tag}: exchange of {rows_in} table rows ({mesh.size} x "
                f"{mesh.size} buckets of {call['cap']}): {1e3 * busy:.3f} ms device time, "
                f"{1e3 * p_wall:.3f} ms wall (torch.profiler; {smi})")
            for cat, secs in categories.most_common(6):
                log(f"[parallel sixframe K={k}] {tag}:   {cat}: {1e3 * secs:.3f} ms")

    t0 = time.perf_counter()
    want_wide = sixframe_aa_count(part, SixFrameCountConfig(K=K_AA_WIDE), device="cuda")
    log(f"[parallel sixframe K={K_AA_WIDE}] single device on {part.size} bases: {time.perf_counter() - t0:.3f} s")
    ref_l, ref_c = numpy_sixframe(part, K_AA_WIDE, codon_table_from_ncbi(NCBI_STANDARD))
    require(np.array_equal(want_wide[1], ref_c) and want_wide[0].tolist() == join_limbs(ref_l).tolist(),
            f"six-frame K={K_AA_WIDE} differs from the numpy reference")
    del ref_l, ref_c

    four = par.Mesh(["cuda:0"] * PARALLEL_RANKS)
    # warm-up on 3 chunks' worth (first use of each torch kernel of the exchange)
    par.sharded_sixframe_aa_count(chrom[: 3 * CHUNK], par.SixFrameCountConfig(K=K_AA), four)
    run("data_mesh(1)", par.data_mesh(1), K_AA, chrom, table_7)
    run(f"{PARALLEL_RANKS} ranks on cuda:0", four, K_AA, chrom, table_7)
    run(f"{PARALLEL_RANKS} ranks on cuda:0", four, K_AA_WIDE, part, want_wide)

    # the CLI's sixframe, sharded over the card, on a FASTA of 1 Mb in two
    # records, against the single-device count of the records joined with N
    records = [chrom[L // 2 : L // 2 + CHUNK // 2], chrom[L // 5 : L // 5 + CHUNK // 2]]
    joined = np.concatenate([records[0], np.frombuffer(b"N", np.uint8), records[1]])
    want = sixframe_aa_count(joined, SixFrameCountConfig(K=K_AA), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        fa = Path(tmp) / "mb.fa"
        _fasta(fa, records)
        totals = json.loads(_cli("sixframe", str(fa), "-k", str(K_AA)))
    require(totals == {"distinct": int(want[0].size), "total": int(want[1].sum())},
            f"CLI sixframe on 1 Mb: {totals}")
    log(f"[parallel sixframe K={K_AA}] CLI on a 1 Mb FASTA: {totals}, equal to one device")

    # one rank a process: an NCCL group of one, built here and torn down after
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = par.data_mesh()
        require(mesh.group is not None and mesh.size == 1, f"NCCL mesh {mesh}")
        # the group's first collectives build its communicator: not timed
        require(mesh.sum([torch.tensor([3, 4])]) == [3, 4] and mesh.max([torch.tensor(5)]) == [5],
                "NCCL reductions")
        par.sharded_sixframe_aa_count(chrom[: 3 * CHUNK], par.SixFrameCountConfig(K=K_AA), mesh)
        run("NCCL world size 1", mesh, K_AA, chrom, table_7)
        run("NCCL world size 1", mesh, K_AA_WIDE, part, want_wide)
    finally:
        dist.destroy_process_group()
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA device",
              file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    chrom = synth_chromosome(CHR21_BASES, seed=21)
    log(f"[data] synthetic chromosome of {chrom.size} bases in {time.perf_counter() - t0:.1f} s")
    entries = phase_kernels(chrom)
    launches_31, table_31 = phase_slice(chrom, smi)
    t0 = time.perf_counter()
    launches_parallel = phase_parallel(chrom, smi, table_31)
    del table_31
    log(f"[parallel] parallel phase in {time.perf_counter() - t0:.1f} s")
    launches_47 = phase_slice_mw(chrom, smi)
    t0 = time.perf_counter()
    launches_sketch = phase_sketch_extract(chrom, smi)
    log(f"[sketch] minhash + extract phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches_sixframe, table_7 = phase_sixframe(chrom, smi)
    log(f"[sixframe] six-frame phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches_parallel += phase_parallel_sixframe(chrom, smi, table_7)
    del table_7
    log(f"[parallel sixframe] sharded six-frame phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches_stream = phase_stream(chrom, smi)
    log(f"[stream] streaming, tables and bench phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches_sort = phase_sort(chrom, smi)
    log(f"[sort] sort phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches_checkpoint = phase_checkpoint(chrom, smi)
    log(f"[checkpoint] checkpoint phase in {time.perf_counter() - t0:.1f} s")
    require("jax" not in sys.modules, "jax was imported")
    require(not [m for m in sys.modules if m.split(".")[0] == "kmers_tpu"],
            "the JAX package was imported")

    # launches: each kernel's count over the paths that run it
    launches = (collections.Counter(launches_31) + collections.Counter(launches_47) + launches_sketch
                + launches_sixframe + collections.Counter(launches_stream)
                + collections.Counter(launches_sort) + collections.Counter(launches_checkpoint)
                + launches_parallel)
    unused = [name for name in entries if not launches[name]]
    require(not unused, f"kernels never launched on their paths: {unused}")
    kernels = [
        {"name": name, "route": e["route"], "source": e["source"], "replaces": e["replaces"],
         "launches": launches[name], "max_abs_err": e["max_abs_err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
         "library_ms": e["library_ms"]}
        for name, e in entries.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
