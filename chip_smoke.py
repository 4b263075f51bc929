#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``kmers_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. device: require CUDA; print the card (nvidia-smi), torch, CUDA and nvcc;
2. build: compile the kernels from ``kmers_tpu_torch/csrc`` with nvcc;
3. kernels: each kernel bit-exact against its plain torch version on the
   card at the main paths' shapes (K1 and K2 at 2^20, K3 at 2^19 and
   K = 32, 33, 47, 63, each front-end on four views), with kernel, plain
   and (for K2) library times (CUDA events, median of 20);
4. slice K = 31: canonical counting of a synthetic 48,129,895-base
   chromosome (the length of GRCh37 chr21) on the card, exactly equal to
   an independent numpy reference, its first 100 kb equal to a
   string-level Counter, the CLI's totals on a 3-record FASTA, and the
   kernels' launch counts from the counting run;
5. slice K = 47 (multi-word registers, K3): the same chromosome, checks and
   launch counts, a stage breakdown with synchronising timers and a
   ``torch.profiler`` breakdown with the device's busy share; then a few
   hundred kb at K = 63 (K3, three words) and K = 80 (plain windows)
   against the numpy reference.

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
#: H100 SXM device memory rate (NVIDIA data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
WORD_BITS = 62


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


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``: ``(wall_s, busy_s,
    {category: device_s}, {kernel: [calls, device_s]})``; ``busy_s`` is the
    union of the device's kernel and copy intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = []
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        per_name[e.name][0] += 1
        per_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e6
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
        if "canonical_windows_mw_kernel" in name:
            cat = "K3 canonical_words"
        elif "rle_unit_kernel" in name:
            cat = "K2 rle_unit"
        elif "dtoh" in low or "device -> pageable" in low or "device -> pinned" in low:
            cat = "download (D2H copies)"
        elif "htod" in low or "-> device" in low:
            cat = "upload (H2D copies)"
        elif ("sort" in low or "radix" in low) and "searchsorted" not in low:
            cat = "torch.sort (radix sort)"
        else:
            cat = "other (elementwise, scan, gather, scatter, search)"
        categories[cat] += secs
    return wall, busy / 1e6, categories, per_name


@contextlib.contextmanager
def stage_timers(module, names):
    """Wrap ``module.<name>`` for each name with synchronising timers;
    yields {name: seconds} and restores the module on exit."""
    import torch

    secs = collections.Counter()
    saved = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        return run

    try:
        for name, fn in saved.items():
            setattr(module, name, timed(name, fn))
        yield secs
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


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


def _views(buf, size, halo):
    """The four views every front-end is checked on: a whole chunk, a
    ragged one, and chunks at the odd offsets 1 and 33."""
    return [
        ("chunk", buf[:size]),
        ("ragged", buf[: size - halo + 7]),
        ("odd offset", buf[1 : 1 + size]),
        ("offset 33", buf[33 : 33 + size - 5]),
    ]


def phase_kernels(chrom: np.ndarray):
    """Each kernel against its plain version; returns {name: entry of the
    kernels line, without launches}."""
    import torch

    from kmers_tpu_torch.convert import SENTINEL, n_words
    from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words, canonical_words_plain
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain
    from kmers_tpu_torch.ops.kernels.window_kernel import (
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
    k1_ms = median_ms(lambda: canonical_windows(clean, K))
    k1_plain_ms = median_ms(lambda: canonical_windows_plain(clean, K))
    log(f"[kernels] K1 at 2^20 bytes, K=31: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")

    k3_err = 0.0
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

    W = n_words(K_MW)
    return {
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
    }


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


def phase_slice(chrom: np.ndarray, smi: str):
    """The K = 31 path; returns its launch counts."""
    import torch

    from kmers_tpu_torch import CountConfig, canonical_count_bytes
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows

    cfg = CountConfig(K=K)
    L = chrom.size
    n_chunks = len(range(0, L - K + 1, cfg.resolved_chunk_size - (K - 1)))
    # warm-up on 3 chunks' worth (first use of torch's sort and scan kernels)
    canonical_count_bytes(chrom[: 3 * CHUNK], cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    canonical_windows.launches = 0
    rle_unit.launches = 0
    t0 = time.perf_counter()
    kmers, counts = canonical_count_bytes(chrom, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {"canonical_windows": canonical_windows.launches, "rle_unit": rle_unit.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice K={K}] {L} bases, {n_chunks} chunks of 2^20: {wall:.3f} s wall, "
        f"{L / wall:.0f} bases/s, {kmers.size} distinct, {int(counts.sum())} counted, "
        f"peak device memory {peak} bytes ({smi})")
    log(f"[slice K={K}] launches during the run: {launches}")
    for name, count in launches.items():
        require(count >= n_chunks, f"{name} launched {count} times for {n_chunks} chunks")

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
    return launches


def phase_slice_mw(chrom: np.ndarray, smi: str):
    """The K > 31 path at K = 47 (K3, then K2 over run ids), plus K = 63 and
    K = 80 on a few hundred kb; returns the K = 47 run's launch counts."""
    import torch

    from kmers_tpu_torch import CountConfig, canonical_count_bytes
    from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit

    tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
    cfg = CountConfig(K=K_MW)
    L = chrom.size
    n_chunks = len(range(0, L - K_MW + 1, cfg.resolved_chunk_size - (K_MW - 1)))
    require(cfg.resolved_chunk_size == CHUNK_MW, "K > 31 chunk size")
    canonical_count_bytes(chrom[: 3 * CHUNK_MW], cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    canonical_words.launches = 0
    rle_unit.launches = 0
    t0 = time.perf_counter()
    kmers, counts = canonical_count_bytes(chrom, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {"canonical_words": canonical_words.launches, "rle_unit": rle_unit.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice K={K_MW}] {L} bases, {n_chunks} chunks of 2^19: {wall:.3f} s wall, "
        f"{L / wall:.0f} bases/s, {kmers.size} distinct, {int(counts.sum())} counted, "
        f"peak device memory {peak} bytes ({smi})")
    log(f"[slice K={K_MW}] launches during the run: {launches}")
    for name, count in launches.items():
        require(count >= n_chunks, f"{name} launched {count} times for {n_chunks} chunks")
    require(kmers.dtype == object and counts.dtype == np.int64, "K=47 output dtypes")

    # where the time goes: synchronising timers around each stage of one
    # call, then the device's view of another under torch.profiler
    stages = ["canonical_words", "sort_count_mw", "compact_counts", "merge_compact_tables_mw",
              "words_to_ints"]
    t0 = time.perf_counter()
    with stage_timers(tcc, stages) as secs:
        canonical_count_bytes(chrom, cfg, device="cuda")
    staged = time.perf_counter() - t0
    rest = staged - sum(secs.values())
    log(f"[slice K={K_MW}] stages (synchronised timers, {staged:.3f} s in all): "
        + ", ".join(f"{name} {secs[name]:.3f} s" for name in stages)
        + f", rest (upload, drain, mask, download) {rest:.3f} s")
    log(f"[slice K={K_MW}] turning words into Python ints: {secs['words_to_ints']:.3f} s")
    p_wall, busy, categories, per_name = device_profile(
        lambda: canonical_count_bytes(chrom, cfg, device="cuda")
    )
    log(f"[slice K={K_MW}] profile: {p_wall:.3f} s wall, device busy {busy:.3f} s "
        f"({100 * busy / p_wall:.1f} % of the call; {smi})")
    for cat, s in categories.most_common():
        log(f"[slice K={K_MW}]   {cat}: {1e3 * s:.3f} ms device time")
    for name, (calls, s) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"[slice K={K_MW}]   kernel {name[:90]}: {calls} calls, {1e3 * s:.3f} ms")

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
    launches_31 = phase_slice(chrom, smi)
    launches_47 = phase_slice_mw(chrom, smi)
    require("jax" not in sys.modules, "jax was imported")
    require(not [m for m in sys.modules if m.split(".")[0] == "kmers_tpu"],
            "the JAX package was imported")

    # launches: each kernel's count over the paths that run it
    launches = collections.Counter(launches_31) + collections.Counter(launches_47)
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
