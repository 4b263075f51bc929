"""The parallel plane's smoke phases alone, on one GPU: build the kernels,
count the synthetic chromosome at K = 31 on one device, then run
``chip_smoke.phase_parallel`` against that table (the full smoke run checks
the table against the numpy reference first; this short loop does not);
then time one device against one rank of the sharded driver at K = 31 in
turns, and profile one call of each.  With ``--sixframe``: count the
chromosome's six-frame K = 7 table on one device and run
``chip_smoke.phase_parallel_sixframe`` against it instead, then time one
device against one rank and four ranks at six-frame K = 7 in turns.

    python tools/parallel_smoke.py [--sixframe]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from kmers_tpu_torch import CountConfig, canonical_count_bytes  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("parallel_smoke: needs a CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    cs.phase_build()
    chrom = cs.synth_chromosome(cs.CHR21_BASES, seed=21)
    if "--sixframe" in sys.argv[1:]:
        return sixframe(chrom, smi)
    canonical_count_bytes(chrom[: 3 * cs.CHUNK], CountConfig(K=cs.K), device="cuda")
    t0 = time.perf_counter()
    table = canonical_count_bytes(chrom, CountConfig(K=cs.K), device="cuda")
    cs.log(f"[parallel_smoke] single device K={cs.K} in {time.perf_counter() - t0:.3f} s ({smi})")
    t0 = time.perf_counter()
    launches = cs.phase_parallel(chrom, smi, table)
    cs.log(f"[parallel_smoke] launches {dict(launches)}; phase in {time.perf_counter() - t0:.1f} s")

    # one device against one rank of the sharded driver, in turns, then a
    # profile of each: where the one-rank call spends its extra time
    from kmers_tpu_torch import parallel as par

    mesh = par.data_mesh(1)
    calls = {
        "one device": lambda: canonical_count_bytes(chrom, CountConfig(K=cs.K), device="cuda"),
        "one rank": lambda: par.sharded_canonical_count(chrom, par.ShardedCountConfig(K=cs.K), mesh),
    }
    walls = {name: [] for name in calls}
    for name in ["one device", "one rank", "one rank", "one device"] * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls[name]()
        walls[name].append(time.perf_counter() - t0)
    for name, ws in walls.items():
        cs.log(f"[parallel_smoke] K={cs.K} {name}: walls {' '.join(f'{w:.3f}' for w in ws)} s ({smi})")
    for name, fn in calls.items():
        wall, busy, categories, _ = cs.device_profile(fn)
        cs.log(f"[parallel_smoke] K={cs.K} {name} profiled: {wall:.3f} s wall, device busy {busy:.3f} s")
        for cat, secs in categories.most_common(6):
            cs.log(f"[parallel_smoke]   {cat}: {1e3 * secs:.3f} ms")
    return 0


def sixframe(chrom, smi: str) -> int:
    import torch

    from kmers_tpu_torch import SixFrameCountConfig, parallel as par, sixframe_aa_count

    cfg = SixFrameCountConfig(K=cs.K_AA)
    sixframe_aa_count(chrom[: 3 * cs.CHUNK], cfg, device="cuda")
    t0 = time.perf_counter()
    table = sixframe_aa_count(chrom, cfg, device="cuda")
    cs.log(f"[parallel_smoke] single device six-frame K={cs.K_AA} in {time.perf_counter() - t0:.3f} s ({smi})")
    t0 = time.perf_counter()
    launches = cs.phase_parallel_sixframe(chrom, smi, table)
    cs.log(f"[parallel_smoke] launches {dict(launches)}; phase in {time.perf_counter() - t0:.1f} s")
    del table

    pcfg = par.SixFrameCountConfig(K=cs.K_AA)
    one, four = par.data_mesh(1), par.Mesh(["cuda:0"] * cs.PARALLEL_RANKS)
    calls = {
        "one device": lambda: sixframe_aa_count(chrom, cfg, device="cuda"),
        "one rank": lambda: par.sharded_sixframe_aa_count(chrom, pcfg, one),
        "four ranks": lambda: par.sharded_sixframe_aa_count(chrom, pcfg, four),
    }
    walls = {name: [] for name in calls}
    for name in ["one device", "one rank", "four ranks", "four ranks", "one rank", "one device"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls[name]()
        walls[name].append(time.perf_counter() - t0)
    for name, ws in walls.items():
        cs.log(f"[parallel_smoke] six-frame K={cs.K_AA} {name}: walls {' '.join(f'{w:.3f}' for w in ws)} s ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
