"""One run of one benchmark cell: set-up, the measured window, the check.

    python -m kmer_bench --workload jellyfish_k31.chr21 --seed 7 --seconds 10 --trace 0

The cell is found by name in ``BENCHMARK.json``: its configuration file,
its traffic file (``kmer_bench/traffic/<traffic>.json``), the entry the
traffic names (``kmer_bench/entries/<entry>.py``) and one reader file per
metric (``kmer_bench/e2e/<metric>.py``, ``kmer_bench/layers/<metric>.py``).
A cell added as new files and new entries runs without an edit here.

Set-up makes the inputs from the seed and warms every shape up once on
the card (the first run of a checkout also builds the kernels).  The
window then drives the entry in a closed loop, one call after another,
for ``--seconds``; before each call one base of its input changes.  With
``--trace 1`` the profiler records the window's first calls (up to
:data:`TRACE_MAX_S` seconds) and the per-layer metrics are read from
that trace.  After the window the reference checks the kept answers, and
the last line of standard output is the result.  A cell on several cards
runs one rank a process (``kmer_bench/ranks.py``); this process is rank 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kmers_tpu"})
#: the longest stretch of the window that a traced run records
TRACE_MAX_S = 10.0
#: the pageable and pinned download probed after the window, bytes
PROBE_BYTES = 1 << 28


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def process_start() -> float:
    """This process's start on the ``time.time`` clock (10 ms steps), or
    now where ``/proc`` does not say."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object
    #: ``[(name, unit, reader)]``
    end_to_end: list
    per_layer: list


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files loaded."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    pkg = root / "kmer_bench"
    traffic = json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text())
    entry = _load(pkg / "entries" / f"{traffic['entry']}.py", f"kmer_bench.entries.{traffic['entry']}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if name in m.get("workloads", [name] if m["moves"] in moved else [])]

    def readers(metrics, folder):
        return [(m["name"], m["unit"], _load(pkg / folder / f"{m['name']}.py", f"kmer_bench.{folder}.{m['name']}"))
                for m in metrics]

    return Cell(name, w["chips"], json.loads((root / conf["file"]).read_text()), traffic, entry,
                readers(e2e, "e2e"), readers(layers, "layers"))


@dataclasses.dataclass
class Context:
    """What an entry gets: the configuration and traffic as run, the
    inputs, the device, and the mesh (None: the entry makes one)."""

    config: dict
    traffic: dict
    inputs: object
    device: str
    seed: int
    mesh: object = None
    #: where an entry writes a line about the run (standard error)
    log: object = print


@dataclasses.dataclass
class Window:
    """The measured window: each call's seconds and work counters, the
    window's length (from the first call's start to the last one's end)
    and the set-up's."""

    calls: list
    window_s: float
    setup_s: float


class Ranks:
    """The harness's side of a multi-process run: this process's rank and
    the group that carries the harness's own flags and objects."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group

    def flags(self, values: list) -> list:
        """Rank 0's ``values`` (ints), on every rank."""
        import torch
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.int64)
        dist.broadcast(t, 0, group=self.group)
        return t.tolist()

    def gather(self, obj) -> list:
        """Every rank's ``obj`` on every rank, in rank order."""
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def smi() -> str:
    """The card's name, clocks, power, power limit and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return " | ".join(out.stdout.strip().splitlines()) or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def d2h_probe(device: str) -> str:
    """Download rates of :data:`PROBE_BYTES` from the card: into fresh
    pageable memory (as ``.cpu()`` gives it, twice) and into pinned
    memory."""
    import torch

    src = torch.empty(PROBE_BYTES, dtype=torch.uint8, device=device)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src.cpu()
        rates.append(PROBE_BYTES / (time.perf_counter() - t0) / 1e9)
    pinned = torch.empty(PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pinned.copy_(src)
    torch.cuda.synchronize()
    rates.append(PROBE_BYTES / (time.perf_counter() - t0) / 1e9)
    del src, pinned
    return f"d2h GB/s: pageable {rates[0]:.2f}, {rates[1]:.2f}; pinned {rates[2]:.2f} ({PROBE_BYTES} bytes)"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             mesh=None, ranks: Ranks | None = None, control: bool = False, log=None) -> dict:
    """Run ``cell`` once and return its result: the line's keys and the
    check's numbers (``"check": [(name, value, limit)]``; on ranks other
    than 0 only what rank 0 gathers).  ``control`` puts the entry's
    control (the reference with one guarantee broken) in the program's
    place."""
    import torch

    from kmer_bench import checks
    from kmer_bench import trace as tr_mod
    from kmer_bench.gen import Inputs

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    rank = ranks.rank if ranks else 0
    on_card = device.startswith("cuda")
    workdir = tempfile.TemporaryDirectory(prefix="kmer_bench-")
    inputs = Inputs(cell.traffic, seed, Path(workdir.name))
    try:
        ctx = Context(cell.config, cell.traffic, inputs, device, seed, mesh, log)
        ent = cell.entry.Entry(ctx)
        if not control:
            ent.warm()
        _sync(device)
        setup_s = time.time() - t_start
        call = (lambda i, spans: ent.control(i)) if control else ent.call
        keeper = checks.Keeper(seed, ent.keep_all)
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
            if on_card:
                # the trace can miss the device's first milliseconds of work
                torch.ones(1, device=device).add_(1)
                torch.cuda.synchronize()
        calls, spans, failed, traced = [], {}, 0, None
        t0 = time.perf_counter()
        i = 0
        while True:
            m = inputs.mutate(i)
            c0 = time.perf_counter()
            try:
                if prof is not None:
                    with record_function(tr_mod.CALL):
                        answer = call(i, spans)
                else:
                    answer = call(i, None)
            except Exception:  # a failed call is counted and the window goes on
                if not failed:
                    log(traceback.format_exc())
                failed, answer = failed + 1, None
            c1 = time.perf_counter()
            calls.append((c1 - c0, ent.work(i)))
            if answer is not None:
                keeper.offer(i, m, answer)
            i += 1
            go, tracing = c1 - t0 < seconds, prof is not None and c1 - t0 < min(seconds, TRACE_MAX_S)
            if ranks:
                go, tracing = ranks.flags([go, tracing])
            if prof is not None and not tracing:
                prof.stop()
                traced = (prof, i)
                prof = None
            if not go:
                break
        window = Window(calls, c1 - t0, setup_s)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        card = torch.cuda.get_device_name() if on_card else "cpu"
        out = {"attempted": len(calls), "failed": failed, "peak": peak, "card": card}
        if on_card and rank == 0 and not control:
            log(f"{cell.name}: {smi()}")
            log(f"{cell.name}: {d2h_probe(device)}")
        if traced is not None:
            prof, n = traced
            work = {}
            for _, w in calls[:n]:
                for key, v in w.items():
                    work[key] = work.get(key, 0) + v
            t = tr_mod.capture(prof, spans, work, card)
            out["layers"] = {name: reader.read(t) for name, _, reader in cell.per_layer}
            out["busy_s"], out["traced_s"] = t.busy_us / 1e6, t.window_us / 1e6
            out["breakdown"] = tr_mod.breakdown(t)
            del prof, t
        else:
            out["e2e"] = {name: reader.read(window) for name, _, reader in cell.end_to_end}
        if on_card:
            torch.cuda.empty_cache()
        kept = keeper.kept()
        if ranks:
            out["rank"] = rank
            out["digests"] = {i: checks.digest(a) for i, (_, a) in kept.items()}
            out["forbidden"] = forbidden_modules()
            everyone = ranks.gather({k: v for k, v in out.items() if k != "breakdown"})
            if rank != 0:
                return out
            out["ranks"] = everyone
        # the reference runs after the window, the program's device memory freed
        t_check = time.perf_counter()
        out["check"] = ent.check(kept) if kept else [("answers_kept", 0, 1)]
        log(f"{cell.name}: {len(kept)} answers checked in {time.perf_counter() - t_check:.1f} s; "
            f"set-up {setup_s:.2f} s, window {window.window_s:.2f} s, {len(calls)} calls")
        if ranks:
            mine = out["digests"]
            out["check"].append(("ranks_disagreeing", sum(r["digests"] != mine for r in everyone[1:]), 0))
        return out
    finally:
        inputs.close()
        workdir.cleanup()


def result_line(cell: Cell, out: dict, trace: bool) -> dict:
    """The result's last line from :func:`run_cell`'s output on rank 0."""
    ranks = out.get("ranks") or [out]
    if trace:
        values = out.get("layers", {})
        units = {name: unit for name, unit, _ in cell.per_layer}
    else:
        values = out.get("e2e", {})
        units = {name: unit for name, unit, _ in cell.end_to_end}
    metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items() if v is not None}
    checks = out["check"]
    failed = sum(r["failed"] for r in ranks)
    correct = bool(out["attempted"] > 0 and failed == 0 and all(v <= lim for _, v, lim in checks))
    device = {"platform": "gpu" if out["card"] != "cpu" else "cpu", "kind": out["card"],
              "count": cell.chips, "memory_peak_bytes": max(r["peak"] for r in ranks)}
    line = {"correct": correct, "attempted": out["attempted"], "failed": failed, "metrics": metrics,
            "device": device}
    if trace:
        device["busy_s"] = sum(r.get("busy_s", 0.0) for r in ranks) / len(ranks)
        device["window_s"] = out.get("traced_s", 0.0)
        line["breakdown"] = out.get("breakdown", {"device_ops": [], "idle_gaps": []})
    line["check"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line


def cache_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for every compiler the
    program or torch may use; the port's kernels build into
    ``kmers_tpu_torch/_build/`` by themselves."""
    cache = root / "kmer_bench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m kmer_bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(argv)
    cache_env()
    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("kmer_bench: torch.cuda.is_available() is false; no run without a card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"kmer_bench: {cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        from kmer_bench import ranks

        out = ranks.launch({"cell": cell.name, "root": str(ROOT), "seed": args.seed, "seconds": args.seconds,
                            "trace": args.trace, "device": "cuda", "world": cell.chips}, t_start)
    else:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = sorted(set(forbidden_modules()).union(*(r["forbidden"] for r in out.get("ranks", []))))
    if found:
        print(f"kmer_bench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for r in out.get("ranks", [])[1:]:
        print(f"{cell.name}: rank {r.get('rank')}: " + json.dumps(
            {k: r[k] for k in ("layers", "busy_s", "traced_s", "peak", "attempted") if k in r}), file=sys.stderr)
    line = result_line(cell, out, bool(args.trace))
    for name, c in line["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
