"""Shared pieces of the benchmark's tests: the repository root on
``sys.path``, each cell cut to a size the CPU runs in a second, and the
card's fixture (decided inside the fixture, never at import)."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: overrides of each cell's configuration and traffic for the CPU: several
#: chunks (so the fold runs), N blocks, reads across batches
SMALL = {
    "jellyfish_k31.chr21": {"config": {"chunk_size": 1 << 14}, "traffic": {"bases": 300_000, "big_n_block": 15_000, "low_complexity": 20_000}},
    "mash_k21_s1000.bacteria": {"traffic": {"lengths": [40_000, 60_000, 80_000]}},
    "jellyfish_k31.reads30x": {"config": {"chunk_size": 1 << 14, "batch_bytes": 1 << 16},
                               "traffic": {"genome_bases": 20_000, "reads": 2_000}},
    "jellyfish_k31.chr21_4gpu": {"config": {"chunk_size": 1 << 14}, "traffic": {"bases": 300_000, "big_n_block": 15_000, "low_complexity": 20_000}},
}


def small_cell(name, root=ROOT):
    from kmer_bench import run

    cell = run.resolve(name, root)
    for key in ("config", "traffic"):
        getattr(cell, key).update(SMALL[name].get(key, {}))
    return cell


def run_small(name, seed=2**31 + 11, seconds=0.3, trace=False, **kw):
    """One run of the cell ``name`` at its CPU size: ``(cell, result line)``."""
    from kmer_bench import run

    cell = small_cell(name)
    out = run.run_cell(cell, seed, seconds, trace, "cpu", time.time(), log=lambda msg: None, **kw)
    return cell, run.result_line(cell, out, trace)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
