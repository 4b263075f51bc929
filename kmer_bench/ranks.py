"""A cell on several cards: one rank a process, joined by
``torch.distributed`` over ``tcp://localhost`` (NCCL on the cards, gloo on
the CPU), with a gloo group of its own for the harness's flags and
objects.

The process that runs ``python -m kmer_bench`` is rank 0: it builds the
kernels once, starts ranks ``1 .. world - 1`` as
``python -m kmer_bench.ranks <spec>`` (with ``LOCAL_RANK`` set), runs its
own rank and prints the result.  A rank that exits with an error ends the
run: rank 0 stops every rank and exits without a result, rather than wait
in a collective that will never complete.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from kmer_bench import run

#: seconds a rank may take to exit once rank 0 is done
EXIT_WAIT_S = 120


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_main(spec: dict, t_start: float) -> dict:
    """Run one rank of the cell ``spec`` describes and return
    :func:`run.run_cell`'s output."""
    import torch
    import torch.distributed as dist

    root = Path(spec["root"])
    run.cache_env(root)
    cell = run.resolve(spec["cell"], root)
    for key in ("config", "traffic"):
        getattr(cell, key).update(spec.get("overrides", {}).get(key, {}))
    cuda = spec["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(spec["rank"])
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{spec['port']}",
                            world_size=spec["world"], rank=spec["rank"])
    try:
        group = dist.new_group(backend="gloo") if cuda else dist.group.WORLD
        from kmers_tpu_torch import parallel as par

        mesh = par.data_mesh(device=spec["device"])
        return run.run_cell(cell, spec["seed"], spec["seconds"], bool(spec["trace"]), str(mesh.devices[0]),
                            t_start, mesh=mesh, ranks=run.Ranks(spec["rank"], spec["world"], group))
    finally:
        dist.destroy_process_group()


def launch(spec: dict, t_start: float) -> dict:
    """Start ranks ``1 .. world - 1``, run rank 0 in this process and
    return its output; every rank has ended when this returns."""
    if spec["device"] == "cuda":
        # build once before the ranks start, so that they load one library
        from kmers_tpu_torch.ops.kernels import _build

        _build.library()
    spec = {**spec, "port": free_port()}
    root = spec["root"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    logs, procs = [], []
    for r in range(1, spec["world"]):
        logs.append(tempfile.TemporaryFile())
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kmer_bench.ranks", json.dumps({**spec, "rank": r})],
            cwd=root, env={**env, "LOCAL_RANK": str(r)}, stdout=subprocess.DEVNULL, stderr=logs[-1]))
    done = threading.Event()

    def relay():
        for r, log in enumerate(logs, 1):
            log.seek(0)
            text = log.read().decode(errors="replace").strip()
            if text:
                print(f"rank {r}:\n{text}", file=sys.stderr, flush=True)

    def watch():
        while not done.wait(0.5):
            if any(p.poll() not in (None, 0) for p in procs):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
                relay()
                print("kmer_bench: a rank failed; no result", file=sys.stderr, flush=True)
                os._exit(1)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        return rank_main({**spec, "rank": 0}, t_start)
    finally:
        done.set()
        watcher.join()
        deadline = time.monotonic() + EXIT_WAIT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        relay()
        for log in logs:
            log.close()


if __name__ == "__main__":
    start = run.process_start()
    rank_main(json.loads(sys.argv[1]), start)
