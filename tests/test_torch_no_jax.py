"""The port never imports jax: a fresh interpreter imports
``kmers_tpu_torch``, runs the main path and the CLI on the CPU, and finds no
``jax`` in ``sys.modules``."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# 'NN' splits the stream into 49 runs of 16 certain bases (10 windows of
# K = 7 each) and two end runs of 8 (2 windows each)
DATA = b"ACGTTGCANNacgtaacc" * 50
TOTAL = 49 * 10 + 2 * 2

SCRIPT = f"""
import json, sys
import kmers_tpu_torch
from kmers_tpu_torch.__main__ import main
kmers, counts = kmers_tpu_torch.canonical_count_bytes(
    {DATA!r}, kmers_tpu_torch.CountConfig(K=7, chunk_size=100), device="cpu",
)
main(["count", sys.argv[1], "-k", "5", "--top", "1", "--device", "cpu"])
print(json.dumps({{"total": int(counts.sum()), "jax": "jax" in sys.modules}}))
"""


def test_port_runs_without_importing_jax(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTACGGTTAC\n>b\nTTGACCA\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(fa)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2  # the CLI's top line, then the script's result
    assert json.loads(lines[-1]) == {"total": TOTAL, "jax": False}
    assert json.loads(proc.stderr.strip().splitlines()[-1])["total"] == (12 - 4) + (7 - 4)


def test_port_sources_do_not_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    for path in [*(ROOT / "kmers_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
