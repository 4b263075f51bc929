"""The port's parallel plane in process-group mode: two CPU processes joined
by ``torch.distributed`` over gloo, one rank each, both holding the whole
input.  Each process must return the whole result, equal to the port on one
device: K = 31 on both routes, K = 47, minimizers, six-frame counting at
K = 7 and K = 12, and a bucket overflow that raises on both ranks."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from kmers_tpu_torch import (
    CountConfig,
    SixFrameCountConfig,
    canonical_count_bytes,
    minimizer_select,
    sixframe_aa_count,
)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2

WORKER = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from kmers_tpu_torch import parallel as par

rank, world, port = (int(x) for x in sys.argv[1:4])
seq = np.fromfile(sys.argv[4], np.uint8)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
try:
    mesh = par.data_mesh(device="cpu")
    clean = seq.copy()
    clean[clean == ord("N")] = ord("A")
    out = {"rank": list(mesh.ranks), "size": mesh.size}
    for name, chunk in (("single", 1 << 20), ("streamed", 1000)):
        k, c = par.sharded_canonical_count(seq, par.ShardedCountConfig(K=31, chunk_size=chunk), mesh)
        out[name] = [k.tolist(), c.tolist()]
    k, c = par.sharded_canonical_count_mw(seq, K=47, mesh=mesh)
    out["k47"] = [[str(int(x)) for x in k], c.tolist()]
    v, p = par.sharded_minimizer_select(clean, 15, 10, mesh)
    out["minimizers"] = [v.tolist(), p.tolist()]
    for k, chunk in ((7, 1000), (12, 1 << 20)):
        aa, c = par.sharded_sixframe_aa_count(seq, par.SixFrameCountConfig(K=k, chunk_size=chunk), mesh)
        out[f"aa{k}"] = [[str(int(x)) for x in aa], c.tolist()]
    try:
        par.sharded_canonical_count(seq, par.ShardedCountConfig(K=31, bucket_factor=0.01), mesh)
        out["overflow"] = None
    except RuntimeError as err:
        out["overflow"] = str(err)
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_each_return_the_whole_result(tmp_path):
    rng = np.random.default_rng(3)
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.choice(5, 8000, p=[0.24, 0.24, 0.24, 0.24, 0.04])]
    seq.tofile(tmp_path / "seq.bin")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(WORLD), str(port), str(tmp_path / "seq.bin")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(WORLD)
    ]
    outs = []
    deadline = time.monotonic() + 120
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            assert p.returncode == 0, stderr.decode()[-3000:]
            outs.append(json.loads(stdout.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    one = canonical_count_bytes(seq, CountConfig(K=31), device="cpu")
    k47 = canonical_count_bytes(seq, CountConfig(K=47), device="cpu")
    clean = seq.copy()
    clean[clean == ord("N")] = ord("A")
    mins = minimizer_select(clean, 15, 10, device="cpu")
    aa = {k: sixframe_aa_count(seq, SixFrameCountConfig(K=k), device="cpu") for k in (7, 12)}
    for r, out in enumerate(outs):
        assert out["rank"] == [r] and out["size"] == WORLD
        for name in ("single", "streamed"):
            assert out[name] == [one[0].tolist(), one[1].tolist()], name
        assert out["k47"] == [[str(int(x)) for x in k47[0]], k47[1].tolist()]
        assert out["minimizers"] == [mins[0].tolist(), mins[1].tolist()]
        for k, (kmers, counts) in aa.items():
            assert out[f"aa{k}"] == [[str(int(x)) for x in kmers], counts.tolist()], k
        assert out["overflow"] == "hash-prefix bucket overflow; increase bucket_factor"
    assert len(one[0]) > 1000 and len(mins[0]) > 500 and len(aa[7][0]) > 1000 and len(aa[12][0]) > 1000
