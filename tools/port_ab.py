"""One side of a parent/change comparison of the PyTorch port on one GPU.

    python tools/port_ab.py ROOT TAG

ROOT is a checkout whose ``kmers_tpu_torch`` is measured (the parent
unpacked with ``git archive`` into a gitignored directory, or the change);
run it for parent, change, change, parent in one session on one card.  It
measures, on ``chip_smoke.py``'s synthetic chromosome: K = 31 and six-frame
K = 7 counting (median wall of three calls, the fold's and K9's CUDA-event
stream time, K9's device time from ``torch.profiler``, the device's busy
time), K9 at the K = 31 fold's last-merge shape (33 M + 14 M rows) and K11
(``bitonic_sort``) against ``torch.sort`` at 2^24 keys; the front-ends'
device time per launch (``torch.profiler``): K1's register mode at 2^20
bytes of the chromosome (K = 15 and 31) and at ``bench``'s 2^26 bytes, its
hash mode on the whole chromosome at K = 21, K3 at 2^19 bytes (K = 47 and
63), K4 (K = 7) and K5 (K = 15 and 32) at 2^20 bytes, K6 on the
chromosome's 2-bit codes (K = 31 forward, K = 15 canonical) and at 2^20
random codes in each of ``GENERAL_CASES``, K8b on the chromosome (K = 32
canonical); ``bench``'s bases/s, and the median wall of three calls of
K = 47 counting, of ``minhash_sketch`` (K = 21, s = 1000) of the
chromosome, of ``extract_kmers`` (K = 31) and ``minimizer_select`` (K = 15,
W = 10) of it and of six-frame K = 15 counting of its first 8 Mb; and
ptxas's registers, shared memory and spills of the front-ends' kernels.
Prints one line ``AB {json}``.  The chromosome is cached in ``build/`` of
this checkout.
"""

import importlib
import json
import statistics
import sys
import time
from pathlib import Path

root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
here = Path(__file__).resolve().parents[1]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (ROOT's copy; its helpers are the same on both sides)
import kmers_tpu_torch  # noqa: E402
from kmers_tpu_torch import (  # noqa: E402
    CountConfig,
    SixFrameCountConfig,
    canonical_count_bytes,
    extract_kmers,
    minhash_sketch,
    minimizer_select,
    sixframe_aa_count,
)
from kmers_tpu_torch.ops import bitonic_sort  # noqa: E402
from kmers_tpu_torch.ops import count as count_ops  # noqa: E402
from kmers_tpu_torch.ops.encode import classify_2bit  # noqa: E402
from kmers_tpu_torch.ops.kernels import _build  # noqa: E402
from kmers_tpu_torch.ops.kernels.general_kernel import windows_general, windows_k32  # noqa: E402
from kmers_tpu_torch.ops.kernels.merge_kernel import merge_tables  # noqa: E402
from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words  # noqa: E402
from kmers_tpu_torch.ops.kernels.sixframe_kernel import sixframe_windows, sixframe_words  # noqa: E402
from kmers_tpu_torch.ops.kernels.window_kernel import canonical_hashes, canonical_windows  # noqa: E402
from kmers_tpu_torch.pipelines import _stream  # noqa: E402

if not Path(kmers_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
    raise SystemExit(f"kmers_tpu_torch came from {kmers_tpu_torch.__file__}, not {root}")
if not torch.cuda.is_available():
    raise SystemExit("port_ab: needs a CUDA device")

cache = here / "build" / "chrom21.npy"
if cache.exists():
    chrom = np.load(cache)
else:
    chrom = cs.synth_chromosome(cs.CHR21_BASES, seed=21)
    cache.parent.mkdir(exist_ok=True)
    np.save(cache, chrom)
#: K6's (bps, K, canonical) at 2^20 random codes (here, not ROOT's chip_smoke: both sides take the same)
GENERAL_CASES = [(2, 31, True), (2, 16, False), (4, 15, True), (4, 9, False), (4, 8, False),
                 (8, 7, False), (8, 1, False)]
#: K9's kernel names before and since its redesign
K9_NAMES = ("merge_tables_kernel", "k9_")
out = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0)}


def k9_device_ms(per_name) -> float:
    return 1e3 * sum(secs for name, (_, secs) in per_name.items() if any(m in name for m in K9_NAMES))


for name, fn, module in [
    ("k31", lambda: canonical_count_bytes(chrom, CountConfig(K=31), device="cuda"),
     "kmers_tpu_torch.pipelines.canonical_count"),
    ("aa7", lambda: sixframe_aa_count(chrom, SixFrameCountConfig(K=7), device="cuda"),
     "kmers_tpu_torch.pipelines.sixframe"),
]:
    fn()  # warm-up
    torch.cuda.synchronize()
    walls, folds, k9s = [], [], []
    targets = [(sys.modules[module], "merge_compact_tables"), (_stream, "compact_counts"),
               (count_ops, "merge_tables")]
    for _ in range(3):
        with cs.stream_timers(targets) as fold:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        folds.append(fold["merge_compact_tables"][1] + fold["compact_counts"][1])
        k9s.append(fold["merge_tables"][1])
    _, busy, _, per_name = cs.device_profile(fn, 1)
    out[name] = {"wall_s": statistics.median(walls), "fold_stream_ms": statistics.median(folds),
                 "k9_stream_ms": statistics.median(k9s), "k9_device_ms": k9_device_ms(per_name),
                 "busy_s": busy}

g = torch.Generator(device="cuda").manual_seed(31)
big_a = torch.unique(torch.randint(0, 1 << 62, (33_000_000,), generator=g, device="cuda"))
big_b = torch.unique(torch.cat([big_a[::16], torch.randint(0, 1 << 62, (12_000_000,), generator=g,
                                                            device="cuda")]))
ca, cb = torch.ones_like(big_a), torch.ones_like(big_b)
out["k9_last_merge_ms"] = cs.median_ms(lambda: merge_tables(big_a, ca, big_b, cb))
_, _, _, per_name = cs.device_profile(lambda: merge_tables(big_a, ca, big_b, cb), 5, warm=True)
out["k9_last_merge_device_ms"] = k9_device_ms(per_name)
del big_a, big_b, ca, cb
keys = torch.randint(-(1 << 62), 1 << 62, (1 << 24,), generator=g, device="cuda")
out["k11_2p24_ms"] = cs.median_ms(lambda: bitonic_sort(keys))
out["torch_sort_2p24_ms"] = cs.median_ms(lambda: torch.sort(keys))
del keys

# the front-ends: device time per launch (K1's kernel names hold
# "canonical_windows_kernel", K3's "canonical_windows_mw_kernel", K4's and
# K5's "sixframe_kernel")
chunk = torch.from_numpy(chrom[: 1 << 20].copy()).to("cuda")
every = (0, 1 << 20, 0, 1 << 20)
whole = torch.from_numpy(chrom).to("cuda")
# (the package re-exports the function canonical_count over the module's name)
cc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
big = torch.from_numpy(cc.bench_input()).to("cuda")
for name, fn, marker in [
    ("k1_2p20_k15_us", lambda: canonical_windows(chunk, 15), "canonical_windows_kernel"),
    ("k1_2p20_k31_us", lambda: canonical_windows(chunk, 31), "canonical_windows_kernel"),
    ("k1_2p26_k31_us", lambda: canonical_windows(big, 31), "canonical_windows_kernel"),
    ("k1_hash_chrom_k21_us", lambda: canonical_hashes(whole, 21), "canonical_windows_kernel"),
    ("k3_2p19_k47_us", lambda: canonical_words(chunk[: 1 << 19], 47), "canonical_windows_mw_kernel"),
    ("k3_2p19_k63_us", lambda: canonical_words(chunk[: 1 << 19], 63), "canonical_windows_mw_kernel"),
    ("k4_2p20_k7_us", lambda: sixframe_windows(chunk, 7, every), "sixframe_kernel"),
    ("k5_2p20_k15_us", lambda: sixframe_words(chunk, 15, every), "sixframe_kernel"),
    ("k5_2p20_k32_us", lambda: sixframe_words(chunk, 32, every), "sixframe_kernel"),
]:
    out[name] = cs.device_us(fn, marker)
# K6 and K8b (kernel names "general_windows_kernel", "windows_k32_kernel")
codes, certain, _ = classify_2bit(whole)
codes = codes.to(torch.uint8)
for name, fn, marker in [
    ("k6_chrom_k31_us", lambda: windows_general(codes, certain, 31, 2, False), "general_windows_kernel"),
    ("k6_chrom_k15_can_us", lambda: windows_general(codes, certain, 15, 2, True), "general_windows_kernel"),
    ("k8b_chrom_can_us", lambda: windows_k32(codes, certain, True), "windows_k32_kernel"),
]:
    out[name] = cs.device_us(fn, marker)
rng = np.random.default_rng(6)
good = torch.from_numpy(rng.random(1 << 20) > 0.005).to("cuda")
for bps, k, canonical in GENERAL_CASES:
    c = torch.from_numpy(rng.integers(0, 1 << bps, 1 << 20).astype(np.uint8)).to("cuda")
    out[f"k6_2p20_bps{bps}_k{k}_{'can' if canonical else 'fw'}_us"] = cs.device_us(
        lambda: windows_general(c, good, k, bps, canonical), "general_windows_kernel")
out["ptxas"] = {name: usage for name, usage in _build.resource_usage().items()
                if any(m in name for m in ("canonical_windows", "sixframe_kernel", "general_windows",
                                           "windows_k32"))}
del chunk, whole, big, codes, certain, c, good
out["bench_bases_per_s"] = cc.bench(device="cuda")["value"]
for name, fn, warm in [
    ("k47", lambda: canonical_count_bytes(chrom, CountConfig(K=47), device="cuda"),
     lambda: canonical_count_bytes(chrom[: 3 << 20], CountConfig(K=47), device="cuda")),
    ("sketch", lambda: minhash_sketch(chrom, K=21, s=1000, device="cuda"), None),
    ("extract", lambda: extract_kmers(chrom, K=31, device="cuda"), None),
    ("minimizers", lambda: minimizer_select(chrom, K=15, W=10, canonical=True, skip_ambiguous=True,
                                            device="cuda"), None),
    ("aa15_8mb", lambda: sixframe_aa_count(chrom[: 8 << 20], SixFrameCountConfig(K=15), device="cuda"),
     lambda: sixframe_aa_count(chrom[: 3 << 20], SixFrameCountConfig(K=15), device="cuda")),
]:
    (warm or fn)()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[f"{name}_wall_s"] = statistics.median(walls)
print("AB " + json.dumps(out), flush=True)
