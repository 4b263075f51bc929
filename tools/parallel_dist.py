"""The parallel plane with one rank a process: this script starts ``--ranks``
copies of itself joined by ``torch.distributed`` over ``tcp://localhost``
(NCCL, one GPU a rank, or gloo on the CPU), and each process, holding the
whole synthetic chromosome of the benchmark's ``chr21`` traffic
(``kmer_bench/gen.py``, ``--bases`` long, seed 21), checks the whole sharded
result against single-device counting on its own device:
``sharded_canonical_count`` at K = 31, ``sharded_canonical_count_mw`` at
K = 47 on the 4 Mb around the poly-A region, ``sharded_minimizer_select``
at K = 15, W = 10, ``sharded_sixframe_aa_count`` at K = 7 on the whole
chromosome and at K = 12 on its 1 Mb at a third, and a bucket overflow
that must raise on every rank.  Each rank's k-mers must be routed to it and
its kernel launches must match its slab's geometry.  It prints each rank's
walls, launches and ``cap``, then one summary line.  The benchmark's
``chr21_4gpu`` cell times the sharded count; this script checks it.

    python tools/parallel_dist.py --ranks 4 --backend nccl       # 4 GPUs
    python tools/parallel_dist.py --ranks 4 --backend gloo --bases 2000000
    python tools/parallel_dist.py --ranks 4 --backend nccl --paths sixframe
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K, K_MW, MW_SLICE = 31, 47, 4_000_000
K_AA, K_AA_WIDE, AA_SLICE = 7, 12, 1 << 20


def chromosome(bases: int):
    """The ``chr21`` traffic's chromosome, ``bases`` long, of seed 21."""
    from kmer_bench.gen import rng_for, synth_chromosome

    traffic = json.loads((ROOT / "kmer_bench" / "traffic" / "chr21.json").read_text())
    return synth_chromosome({**traffic, "bases": bases}, rng_for(21))


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


def fold_geometry(n_ranks: int, L: int, k: int, chunk: int) -> dict:
    """K1, K2, K9 and K10 launches of a sharded K <= 31 count: per rank one
    K1 and one K2 a slab chunk; on the streamed route one K10 a chunk and,
    for each of the chunks - 1 merges of the level stack, one K9 and one
    K10.  A slab of one chunk is counted in one dispatch and not folded."""
    shard = -(-L // n_ranks)
    steps = len(range(0, shard, chunk - (k - 1))) if -(-shard // chunk) > 1 else 1
    return {"canonical_windows": n_ranks * steps, "rle_unit": n_ranks * steps,
            "merge_tables": n_ranks * (steps - 1),
            "compact_table": n_ranks * (2 * steps - 1) if steps > 1 else 0}


def sixframe_geometry(n_ranks: int, L: int, k: int, chunk: int, words: bool) -> dict:
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


def worker(args) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from kmers_tpu_torch import (
        CountConfig,
        SixFrameCountConfig,
        canonical_count_bytes,
        minimizer_select,
        sixframe_aa_count,
    )
    from kmers_tpu_torch import parallel as par
    from kmers_tpu_torch.ops.hashing import fx_hash_u64
    from kmers_tpu_torch.ops.kernels.sixframe_kernel import sixframe_windows, sixframe_words
    from kmers_tpu_torch.ops.multiword import fx_hash_mw
    from kmers_tpu_torch.ops.kernels.general_kernel import windows_general
    from kmers_tpu_torch.ops.kernels.merge_kernel import compact_table, merge_tables
    from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words
    from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit
    from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows

    pipe = sys.modules["kmers_tpu_torch.parallel.pipeline"]
    dist.init_process_group(args.backend, init_method=f"tcp://localhost:{args.port}",
                            world_size=args.ranks, rank=args.rank)
    try:
        mesh = par.data_mesh(device="cuda" if args.backend == "nccl" else "cpu")
        dev = mesh.devices[0]
        on_gpu = dev.type == "cuda"
        if on_gpu:
            torch.cuda.set_device(dev)

        def sync():
            if on_gpu:
                torch.cuda.synchronize(dev)
            dist.barrier()

        chrom = chromosome(args.bases)
        L = chrom.size
        out = {"rank": mesh.ranks[0], "size": mesh.size, "device": str(dev)}
        if on_gpu:
            out["card"] = torch.cuda.get_device_name(dev)
        if "canonical" in args.paths:
            cfg = par.ShardedCountConfig(K=K)
            canonical_count_bytes(chrom[: 3 * (1 << 20)], CountConfig(K=K), device=dev)
            par.sharded_canonical_count(chrom[: 3 * (1 << 20)], cfg, mesh)  # warm-up
            sync()
            t0 = time.perf_counter()
            want = canonical_count_bytes(chrom, CountConfig(K=K), device=dev)
            sync()
            out["one_device_s"] = time.perf_counter() - t0

            fold = {"canonical_windows": canonical_windows, "rle_unit": rle_unit,
                    "merge_tables": merge_tables, "compact_table": compact_table}
            for fn in fold.values():
                fn.launches = 0
            with capture_exchanges(pipe, "exchange_and_merge") as calls:
                sync()
                t0 = time.perf_counter()
                got = par.sharded_canonical_count(chrom, cfg, mesh)
                sync()
                out["sharded_s"] = time.perf_counter() - t0
            out["launches"] = {name: fn.launches for name, fn in fold.items()}
            out["geometry"] = {name: n // mesh.size
                               for name, n in fold_geometry(mesh.size, L, K, cfg.chunk_size).items()}
            (call,) = calls
            out["cap"], out["overflow"] = call["cap"], call["overflow"]
            out["k31_equal"] = bool(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]))
            ((keys, counts, _),) = call["merged"]
            out["routed_to_self"] = bool(
                (pipe.destination(fx_hash_u64(keys[counts > 0]), mesh.size) == mesh.ranks[0]).all()
            )
            del want, got, call, calls

            part = chrom[L // 3 - MW_SLICE // 2 : L // 3 + MW_SLICE // 2]
            want = canonical_count_bytes(part, CountConfig(K=K_MW), device=dev)
            canonical_words.launches = 0
            sync()
            t0 = time.perf_counter()
            got = par.sharded_canonical_count_mw(part, K=K_MW, mesh=mesh)
            sync()
            out["k47_s"], out["k47_launches"] = time.perf_counter() - t0, canonical_words.launches
            out["k47_equal"] = bool(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]))

            want = minimizer_select(chrom, K=15, W=10, canonical=True, skip_ambiguous=True, device=dev)
            windows_general.launches = 0
            sync()
            t0 = time.perf_counter()
            got = par.sharded_minimizer_select(chrom, K=15, W=10, mesh=mesh, skip_ambiguous=True)
            sync()
            out["minimizers_s"], out["minimizer_launches"] = time.perf_counter() - t0, windows_general.launches
            out["minimizers_equal"] = bool(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]))
            del want, got

            try:
                par.sharded_canonical_count(chrom[: 1 << 20], par.ShardedCountConfig(K=K, bucket_factor=0.01), mesh)
                out["overflow_raised"] = False
            except RuntimeError as err:
                out["overflow_raised"] = "overflow" in str(err)
        if "sixframe" in args.paths:
            psix = sys.modules["kmers_tpu_torch.parallel.sixframe"]
            six = {"sixframe_windows": sixframe_windows, "sixframe_words": sixframe_words, "rle_unit": rle_unit,
                   "merge_tables": merge_tables, "compact_table": compact_table}
            aa_part = chrom[max(L // 3 - AA_SLICE // 2, 0) :][:AA_SLICE]
            warm = chrom[: 3 * (1 << 20)]
            sixframe_aa_count(warm, SixFrameCountConfig(K=K_AA), device=dev)
            par.sharded_sixframe_aa_count(warm, par.SixFrameCountConfig(K=K_AA), mesh)  # warm-up
            for k, seq in ((K_AA, chrom), (K_AA_WIDE, aa_part)):
                tag = f"aa{k}"
                want = sixframe_aa_count(seq, SixFrameCountConfig(K=k), device=dev)
                for fn in six.values():
                    fn.launches = 0
                with capture_exchanges(psix, "_exchange_tables") as calls:
                    sync()
                    t0 = time.perf_counter()
                    got = par.sharded_sixframe_aa_count(seq, par.SixFrameCountConfig(K=k), mesh)
                    sync()
                    out[f"{tag}_s"] = time.perf_counter() - t0
                geometry = dict.fromkeys(six, 0)
                geometry.update(sixframe_geometry(mesh.size, seq.size, k, 1 << 20, k > K_AA))
                out[f"{tag}_launches"] = {name: fn.launches for name, fn in six.items()}
                out[f"{tag}_geometry"] = {name: n // mesh.size for name, n in geometry.items()}
                out[f"{tag}_equal"] = bool(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]))
                (call,) = calls
                out[f"{tag}_cap"], out[f"{tag}_overflow"] = call["cap"], call["overflow"]
                ((keys, counts, _),) = call["merged"]
                real = keys[..., counts > 0]
                hashes = fx_hash_u64(real) if k <= K_AA else fx_hash_mw(real, k, bps=8)
                out[f"{tag}_routed_to_self"] = bool((pipe.destination(hashes, mesh.size) == mesh.ranks[0]).all())
                del call, calls, want, got
        sync()
        return out
    finally:
        dist.destroy_process_group()


def launch(args) -> int:
    import socket

    if args.backend == "nccl":
        # build once before the ranks start, so that they load one library
        from kmers_tpu_torch.ops.kernels import _build

        _build.library()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(r), "--ranks", str(args.ranks), "--port", str(port),
             "--backend", args.backend, "--bases", str(args.bases), "--paths", *args.paths],
            cwd=ROOT, env={**env, "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE, text=True,
        )
        for r in range(args.ranks)
    ]
    lines, deadline = [], time.monotonic() + args.timeout
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            if p.returncode != 0:
                print(f"parallel_dist: a rank exited {p.returncode}", file=sys.stderr)
                return 1
            lines.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for line in lines:
        print(json.dumps(line))
    # on GPUs each rank launches what its slab's geometry gives, one K3 and
    # one K6; on the CPU the plain versions run and nothing launches
    gpu = args.backend == "nccl"

    def launched(line, key, geometry):
        return line[key] == (line[geometry] if gpu else dict.fromkeys(line[geometry], 0))

    ok = True
    for line in lines:
        if "canonical" in args.paths:
            ok &= all(line[c] for c in ("k31_equal", "routed_to_self", "k47_equal", "minimizers_equal",
                                        "overflow_raised"))
            ok &= line["overflow"] == 0 and launched(line, "launches", "geometry")
            ok &= line["k47_launches"] == line["minimizer_launches"] == int(gpu)
        if "sixframe" in args.paths:
            for tag in ("aa7", "aa12"):
                ok &= line[f"{tag}_equal"] and line[f"{tag}_routed_to_self"] and line[f"{tag}_overflow"] == 0
                ok &= launched(line, f"{tag}_launches", f"{tag}_geometry")
    print(json.dumps({"ok": bool(ok), "ranks": args.ranks, "backend": args.backend, "bases": args.bases,
                      "paths": args.paths}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--bases", type=int, default=48_129_895)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--paths", nargs="+", choices=("canonical", "sixframe"), default=["canonical", "sixframe"],
                    help="the sharded paths to run: canonical (K = 31, K = 47, minimizers, overflow) "
                    "and six-frame (K = 7, K = 12)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is None:
        return launch(args)
    args.rank = args.worker
    print(json.dumps(worker(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
