"""The minimizer cell ``minimap2_k15w10.chr21`` on the CPU, cut here to a
size the CPU runs in seconds (chunks of 2^14 windows, so the walk crosses
seams): a sound run reads ``correct`` true with no forbidden module loaded,
the control and each planted fault read false, the check applies the
changed base, and the six readers on a synthetic trace.  The reference
itself is held to the port and to the JAX package in
``tests/test_torch_minimizer_reference.py``."""

import importlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import ROOT

from kmer_bench import run
from kmer_bench.trace import Trace

tex = importlib.import_module("kmers_tpu_torch.pipelines.extract")

CELL = "minimap2_k15w10.chr21"
#: the cell cut for the CPU: 300 kb with 2 of the 20 N blocks
SMALL = {"traffic": {"bases": 300_000, "big_n_block": 15_000, "low_complexity": 20_000, "n_blocks": 2}}
LAYERS = ["k6_roofline.mm", "select_ms.mm", "minimum_rows.mm", "d2h_ms.mm", "wait_ms.mm", "idle_pct.mm"]


@pytest.fixture(autouse=True)
def _chunks(monkeypatch):
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", 1 << 14)


def small_cell():
    cell = run.resolve(CELL)
    for key, values in SMALL.items():
        getattr(cell, key).update(values)
    return cell


def run_small(seed=2**31 + 37, seconds=0.3, trace=False, **kw):
    cell = small_cell()
    out = run.run_cell(cell, seed, seconds, trace, "cpu", time.time(), log=lambda msg: None, **kw)
    return run.result_line(cell, out, trace)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    line = run_small(trace=trace)
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    assert line["check"] == {"minimizers_wrong": {"value": 0, "limit": 0}}
    if trace:
        # on the CPU only the program's spans and counters have something to read
        assert set(line["metrics"]) == {"minimum_rows.mm", "wait_ms.mm"}
        assert 4.0 < line["metrics"]["minimum_rows.mm"]["value"] < 4.1
    else:
        assert set(line["metrics"]) == {"setup_s", "bases_per_s"}


def test_the_control_is_not_correct():
    line = run_small(seconds=0.0, control=True)
    assert not line["correct"] and line["check"]["minimizers_wrong"]["value"] > 0


def _stale(fn):
    first = []

    def stale(*a, **kw):
        if not first:
            first.append(fn(*a, **kw))
        return first[0]

    return stale


def _drop_last_row(fn):
    def drop(*a, **kw):
        values, positions = fn(*a, **kw)
        return values[:-1], positions[:-1]

    return drop


def _seam_repeats(fn):
    """The walk without its seam rule: a pick that spans a seam twice."""
    def walk(*a, **kw):
        values, positions = fn(*a, **kw)
        return np.insert(values, 1, values[0]), np.insert(positions, 1, positions[0])

    return walk


FAULTS = [
    ("state unchanged", "minimizer_select", _stale),
    ("a row dropped", "minimizer_select", _drop_last_row),
    ("a repeated row", "minimizer_select", _seam_repeats),
]


@pytest.mark.parametrize("fault,attr,plant", FAULTS, ids=[f[0] for f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, attr, plant):
    import kmers_tpu_torch

    monkeypatch.setattr(kmers_tpu_torch, attr, plant(getattr(kmers_tpu_torch, attr)))
    line = run_small()
    assert not line["correct"], fault


def test_the_check_applies_the_changed_base():
    from kmer_bench.gen import Inputs
    from kmer_bench.reference import minimizers as ref

    inputs = Inputs(small_cell().traffic, 5)
    before = ref.minimizers(inputs.sequence(0), 15, 10)
    m = inputs.mutate(0)
    after = ref.minimizers(inputs.sequence(0), 15, 10)
    sampling = run.resolve(CELL).entry.sampling
    assert sampling(inputs, 15, 10, True, {0: (m, after)}) == [("minimizers_wrong", 0, 0)]
    # the sampling of the chromosome before its base changed is wrong
    assert not (np.array_equal(before[0], after[0]) and np.array_equal(before[1], after[1]))
    assert sampling(inputs, 15, 10, True, {0: (m, before)})[0][1] > 0


def test_rows_wrong_counts_rows_exactly():
    rows_wrong = run.resolve(CELL).entry.rows_wrong
    v, p = np.array([5, 6, 7], np.uint64), np.array([1, 4, 9], np.int64)
    assert rows_wrong(v, p, v, p) == 0
    assert rows_wrong(v[:2], p[:2], v, p) == 1
    assert rows_wrong(np.array([5, 6, 8], np.uint64), p, v, p) == 2
    assert rows_wrong(np.insert(v, 1, 5), np.insert(p, 1, 1), v, p) == 1
    assert rows_wrong(v.astype(np.int64), p, v, p) == 6


DRIVE = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import importlib
importlib.import_module("kmers_tpu_torch.pipelines.extract").MINIMIZER_CHUNK_WINDOWS = 1 << 14
from test_kbench_minimizers import run_small
for trace in (False, True):
    assert run_small(seconds=0.2, trace=trace)["correct"]
run_small(seconds=0.0, control=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_drive_of_the_cell_loads_no_jax():
    code = DRIVE.format(root=str(ROOT), tests=str(ROOT / "kmer_bench" / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "kmers_tpu_torch" in loaded and "kmer_bench" in loaded
    assert not loaded & run.FORBIDDEN


# -- the cell and its readers -------------------------------------------------

def test_the_cell_resolves_to_its_files():
    cell = run.resolve(CELL)
    assert cell.chips == 1 and (cell.config["K"], cell.config["W"]) == (15, 10)
    assert cell.config["canonical"] and cell.config["skip_ambiguous"] and cell.config["reduced"] == ["input"]
    assert cell.traffic["entry"] == "minimizer_select"
    assert [n for n, _, _ in cell.end_to_end] == ["setup_s", "bases_per_s"]
    assert [n for n, _, _ in cell.per_layer] == LAYERS
    chr21 = json.loads((ROOT / "kmer_bench" / "traffic" / "chr21.json").read_text())
    assert {k: v for k, v in cell.traffic.items() if k not in ("entry", "why")} == \
        {k: v for k, v in chr21.items() if k not in ("entry", "why")}


H100 = "NVIDIA H100 80GB HBM3"
K6 = "void (anonymous namespace)::general_windows_kernel<2, true>(unsigned char const*, unsigned char const*, long, int, long*)"


def _layer(name):
    return run._load(ROOT / "kmer_bench" / "layers" / f"{name}.py", f"layer_{name}")


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    """Two calls of 1000 us; device time in us: K6 10 + 10, elementwise 30 +
    20, nonzero 5, memset 1, D2H 300; the wait span 40 a call."""
    dev = [
        (K6, 0, 10), (K6, 1000, 1010),
        ("void at::native::vectorized_elementwise_kernel<...>", 20, 50),
        ("void at::native::elementwise_kernel<...>", 1020, 1040),
        ("void cub::DeviceSelectSweepKernel<...>", 60, 65), ("Memset (Device)", 70, 71),
        ("Memcpy DtoH (Device -> Pinned)", 600, 900),
    ]
    host = [("kmers.wait", 100, 120), ("kmers.wait", 500, 520), ("kmers.wait", 1100, 1140)]
    tr = Trace(dev, host, [(0, 1000), (1000, 2000)], {}, {"k6_positions": 2_000_000, "bases": 2_000_000}, H100)
    assert _layer("k6_roofline.mm").read(tr) == pytest.approx(100 * 10 * 2e6 / 3.35e12 / 20e-6)
    assert _layer("select_ms.mm").read(tr) == pytest.approx(0.0275)
    assert _layer("d2h_ms.mm").read(tr) == pytest.approx(0.15)
    assert _layer("wait_ms.mm").read(tr) == pytest.approx(0.04)
    busy = 10 + 10 + 30 + 20 + 5 + 1 + 300
    assert _layer("idle_pct.mm").read(tr) == pytest.approx(100 * (1 - busy / 2000))
    from kmers_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"minimum_rows": 8_000_040, "minimizer_windows": 2_000_000})
    assert _layer("minimum_rows.mm").read(tr) == pytest.approx(4.00002)
    # the parent program keeps neither counter nor the wait span
    monkeypatch.setattr(profiling, "counters", lambda: {"download_bytes": 1})
    assert _layer("minimum_rows.mm").read(tr) is None
    empty = Trace([], [], [(0, 10)], {}, {}, H100)
    assert all(_layer(name).read(empty) is None for name in LAYERS)
