#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``kmers_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. device: require CUDA; print the card (nvidia-smi), torch, CUDA and nvcc;
2. build: compile the kernels from ``kmers_tpu_torch/csrc`` with nvcc;
3. kernels: each kernel bit-exact against its plain torch version on the
   card at the main path's shapes (2^20-byte chunks), with kernel and plain
   times (CUDA events, median of 20);
4. slice: canonical 31-mer counting of a synthetic 48,129,895-base
   chromosome (the length of GRCh37 chr21) on the card, exactly equal to an
   independent numpy reference, its first 100 kb equal to a string-level
   Counter, the CLI's totals on a 3-record FASTA, and the kernels' launch
   counts from the counting run.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
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
    """Sorted distinct canonical k-mers (uint64) and counts, computed with
    numpy alone: forward registers shifted in over k passes, reverse
    complements as forward registers of the complemented reversed stream,
    validity from a cumulative sum of non-ACGTU bytes."""
    L = seq.size
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    up = seq & 0xDF
    good = np.isin(up, np.frombuffer(b"ACGTU", np.uint8))
    codes = (((seq >> 1) ^ (seq >> 2)) & 3).astype(np.uint64)

    def forward(c):
        reg = np.zeros(n, np.uint64)
        for j in range(k):
            np.left_shift(reg, np.uint64(2), out=reg)
            np.bitwise_or(reg, c[j : j + n], out=reg)
        return reg

    fw = forward(codes)
    rc = forward((np.uint64(3) - codes)[::-1].copy())[::-1]
    np.minimum(fw, rc, out=fw)
    del rc
    bad = np.concatenate([[0], np.cumsum(~good, dtype=np.int64)])
    valid = (bad[k:] - bad[:n]) == 0
    kmers, counts = np.unique(fw[valid], return_counts=True)
    return kmers, counts.astype(np.int64)


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
        f"(flags: {' '.join(_build.NVCC_FLAGS)})")


def phase_kernels(chrom: np.ndarray):
    import torch

    from kmers_tpu_torch.convert import SENTINEL
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain
    from kmers_tpu_torch.ops.kernels.window_kernel import (
        canonical_windows,
        canonical_windows_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    # K1 inputs: one 2^20-byte chunk with mixed case, N blocks, IUPAC codes
    # and one invalid byte, held in a buffer so views can start unaligned
    host = chrom[:CHUNK + 64].copy()
    host[1000:1300] = ord("N")
    host[rng.integers(0, host.size, 50)] = np.frombuffer(b"RYKMrykm-n", np.uint8)[rng.integers(0, 10, 50)]
    host[CHUNK // 2] = ord("X")
    buf = torch.from_numpy(host).to(dev)
    k1_err = 0.0
    for k in (1, 15, 31):
        for name, view in [
            ("chunk", buf[:CHUNK]),
            ("ragged", buf[: CHUNK - 30 + 7]),
            ("odd offset", buf[1 : 1 + CHUNK]),
            ("offset 33", buf[33 : 33 + CHUNK - 5]),
        ]:
            got = canonical_windows(view, k)
            want = canonical_windows_plain(view, k)
            torch.cuda.synchronize()
            require(all(torch_equal(g, w) for g, w in zip(got, want)),
                    f"K1 != plain at K={k}, {name}")
            require(int(got[1]) == 1, f"K1 invalid count at K={k}, {name}")
            k1_err = max(k1_err, max_abs_err(got, want))
        log(f"[kernels] K1 canonical_windows K={k}: bit-equal to plain on 4 views "
            f"(n_invalid={int(got[1])}, n_ambig={int(got[2])})")
    clean = torch.from_numpy(chrom[:CHUNK].copy()).to(dev)
    k1_ms = median_ms(lambda: canonical_windows(clean, K))
    k1_plain_ms = median_ms(lambda: canonical_windows_plain(clean, K))
    log(f"[kernels] K1 at 2^20 bytes, K=31: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")

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
    log(f"[kernels] K2 at 2^20 keys: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")
    return {
        "canonical_windows": (k1_err, k1_ms, k1_plain_ms),
        "rle_unit": (k2_err, k2_ms, k2_plain_ms),
    }


def phase_slice(chrom: np.ndarray, smi: str):
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
    log(f"[slice] {L} bases, K={K}, {n_chunks} chunks of 2^20: {wall:.3f} s wall, "
        f"{L / wall:.0f} bases/s, {kmers.size} distinct, {int(counts.sum())} counted, "
        f"peak device memory {peak} bytes ({smi})")
    log(f"[slice] launches during the run: {launches}")
    for name, count in launches.items():
        require(count >= n_chunks, f"{name} launched {count} times for {n_chunks} chunks")

    require(kmers.dtype == np.uint64 and counts.dtype == np.int64, "output dtypes")
    t0 = time.perf_counter()
    ref_k, ref_c = numpy_reference(chrom, K)
    log(f"[slice] numpy reference in {time.perf_counter() - t0:.1f} s: {ref_k.size} distinct")
    require(np.array_equal(kmers, ref_k) and np.array_equal(counts, ref_c),
            "counts differ from the numpy reference")
    log("[slice] equal to the numpy reference")

    head = chrom[:100_000]
    got = canonical_count_bytes(head, cfg, device="cuda")
    want = string_counter(head.tobytes().decode(), K)
    require(dict(zip(got[0].tolist(), got[1].tolist())) == want,
            "first 100 kb differ from the string Counter")
    log(f"[slice] first 100 kb equal to the string-level Counter ({len(want)} distinct)")

    records = [chrom[200_000:400_000], chrom[500_000:501_000], chrom[L // 2 - 30_000 : L // 2 + 20_000]]
    ref = numpy_reference(np.concatenate([np.concatenate([r, [ord("N")]]) for r in records])[:-1], K)
    with tempfile.TemporaryDirectory() as tmp:
        fa = Path(tmp) / "reads.fa"
        fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, r.tobytes()) for i, r in enumerate(records)))
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        proc = subprocess.run(
            [sys.executable, "-m", "kmers_tpu_torch", "count", str(fa), "-k", str(K), "--top", "3"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
    require(proc.returncode == 0, f"CLI failed: {proc.stderr[-2000:]}")
    totals = json.loads(proc.stderr.strip().splitlines()[-1])
    require(totals == {"distinct": int(ref[0].size), "total": int(ref[1].sum())},
            f"CLI totals {totals}")
    require(len(proc.stdout.strip().splitlines()) == 3, "CLI top lines")
    log(f"[slice] CLI on a 3-record FASTA: {totals}")
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
    timing = phase_kernels(chrom)
    launches = phase_slice(chrom, smi)
    require("jax" not in sys.modules, "jax was imported")

    sources = {
        "canonical_windows": ("kmers_tpu_torch/csrc/window_kernel.cu",
                              "kmers_tpu/ops/pallas/window_kernel.py:518"),
        "rle_unit": ("kmers_tpu_torch/csrc/rle_kernel.cu",
                     "kmers_tpu/ops/pallas/rle_kernel.py:150"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": timing[name][0],
         "ms": timing[name][1], "plain_ms": timing[name][2]}
        for name, (src, rep) in sources.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
