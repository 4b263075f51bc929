"""The six-frame cell ``sixframe_k7.chr21`` on the CPU, cut here to a size
the CPU runs in seconds (chunks of 2^14 bases, so the fold runs): a sound
run reads ``correct`` true with no forbidden module loaded, the control and
each planted fault read false, and the six readers on a synthetic trace.
The reference itself is held to a brute-force translation in
``tests/test_torch_sixframe_reference.py``."""

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

sf = importlib.import_module("kmers_tpu_torch.pipelines.sixframe")

CELL = "sixframe_k7.chr21"
#: the cell cut for the CPU: 300 kb in chunks of 2^14 bases, with 2 of the
#: 20 N blocks
SMALL = {"config": {"chunk_size": 1 << 14},
         "traffic": {"bases": 300_000, "big_n_block": 15_000, "low_complexity": 20_000, "n_blocks": 2}}
LAYERS = ["k4_roofline.aa", "sort_ms.aa", "fold_ms.aa", "d2h_ms.aa", "idle_pct.aa", "merge_rows.aa"]


def small_cell():
    cell = run.resolve(CELL)
    for key in ("config", "traffic"):
        getattr(cell, key).update(SMALL[key])
    return cell


def run_small(seed=2**31 + 29, seconds=0.3, trace=False, **kw):
    cell = small_cell()
    out = run.run_cell(cell, seed, seconds, trace, "cpu", time.time(), log=lambda msg: None, **kw)
    return run.result_line(cell, out, trace)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    line = run_small(trace=trace)
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    assert line["check"] == {"rows_wrong": {"value": 0, "limit": 0}}
    if trace:
        # on the CPU only the program's counters have something to read
        assert set(line["metrics"]) == {"merge_rows.aa"}
        assert 1 < line["metrics"]["merge_rows.aa"]["value"] < 8
    else:
        assert set(line["metrics"]) == {"setup_s", "bases_per_s"}


def test_the_control_is_not_correct():
    line = run_small(seconds=0.0, control=True)
    assert not line["correct"] and line["check"]["rows_wrong"]["value"] > 0


def _stale(fn):
    first = []

    def stale(*a, **kw):
        if not first:
            first.append(fn(*a, **kw))
        return first[0]

    return stale


def _drop_last_row(fn):
    def drop(*a, **kw):
        keys, counts = fn(*a, **kw)
        return keys[:-1], counts[:-1]

    return drop


def _count_off_by_one(fn):
    def bump(*a, **kw):
        keys, counts, n = fn(*a, **kw)
        counts = counts.clone()
        counts[0] += 1
        return keys, counts, n

    return bump


FAULTS = [
    ("state unchanged", "count_stream", _stale),
    ("a row dropped", "download_table", _drop_last_row),
    ("a count off by one", "merge_compact_tables", _count_off_by_one),
]


@pytest.mark.parametrize("fault,attr,plant", FAULTS, ids=[f[0] for f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, attr, plant):
    monkeypatch.setattr(sf, attr, plant(getattr(sf, attr)))
    line = run_small()
    assert not line["correct"], fault


def test_the_check_applies_the_changed_base():
    from kmer_bench.gen import Inputs
    from kmer_bench.reference import sixframe as ref

    inputs = Inputs(small_cell().traffic, 5)
    before = ref.count_table(inputs.sequence(0), 7)
    m = inputs.mutate(0)
    after = ref.count_table(inputs.sequence(0), 7)
    tables = run.resolve(CELL).entry.tables
    assert tables(inputs, 7, {0: (m, after)}) == [("rows_wrong", 0, 0)]
    # the table of the chromosome before its base changed is wrong
    assert before[0].size != after[0].size or not np.array_equal(before[1], after[1])
    assert tables(inputs, 7, {0: (m, before)})[0][1] > 0


DRIVE = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from test_kbench_sixframe import run_small
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
    assert cell.chips == 1 and cell.config["K"] == 7 and cell.config["chunk_size"] == 1 << 20
    assert cell.config["code"] == 1 and cell.traffic["entry"] == "sixframe_count" and cell.config["reduced"] == []
    assert [n for n, _, _ in cell.end_to_end] == ["setup_s", "bases_per_s"]
    assert [n for n, _, _ in cell.per_layer] == LAYERS
    chr21 = json.loads((ROOT / "kmer_bench" / "traffic" / "chr21.json").read_text())
    assert {k: v for k, v in cell.traffic.items() if k not in ("entry", "why")} == \
        {k: v for k, v in chr21.items() if k not in ("entry", "why")}


H100 = "NVIDIA H100 80GB HBM3"
K4 = "void (anonymous namespace)::sixframe_kernel<1>(unsigned char const*, long, int, Bounds, DualTable, long*, unsigned long long*)"
K5 = K4.replace("<1>", "<2>")


def _layer(name):
    return run._load(ROOT / "kmer_bench" / "layers" / f"{name}.py", f"layer_{name}")


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    """Two calls of 1000 us; device time in us: K4 10 + 10, radix sort 40,
    K2 6, K9 20, K10 12, searchsorted 5, D2H 300, K5 3 (not K4's)."""
    dev = [
        (K4, 0, 10), (K4, 1000, 1010),
        ("void cub::DeviceRadixSortOnesweepKernel<...>", 20, 60), ("rle_unit_kernel(long const*, long)", 60, 66),
        ("k9_merge_kernel(kmers::MergeSpec, long const*)", 70, 90),
        ("compact_scatter_kernel(long const*, long const*, long, int)", 110, 122),
        ("void at::native::searchsorted_cuda_kernel<long>", 130, 135),
        ("Memcpy DtoH (Device -> Pinned)", 600, 900), (K5, 1100, 1103),
    ]
    tr = Trace(dev, [], [(0, 1000), (1000, 2000)], {}, {"k4_positions": 2_000_000, "bases": 2_000_000}, H100)
    assert _layer("k4_roofline.aa").read(tr) == pytest.approx(100 * 17 * 2e6 / 3.35e12 / 20e-6)
    assert _layer("sort_ms.aa").read(tr) == pytest.approx(0.023)
    assert _layer("fold_ms.aa").read(tr) == pytest.approx(0.0185)
    assert _layer("d2h_ms.aa").read(tr) == pytest.approx(0.15)
    busy = 10 + 10 + 40 + 6 + 20 + 12 + 5 + 300 + 3
    assert _layer("idle_pct.aa").read(tr) == pytest.approx(100 * (1 - busy / 2000))
    from kmers_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"merge_rows": 12_000_000, "aa_windows": 2_000_000})
    assert _layer("merge_rows.aa").read(tr) == pytest.approx(6.0)
    # the parent program keeps neither counter
    monkeypatch.setattr(profiling, "counters", lambda: {"download_bytes": 1})
    assert _layer("merge_rows.aa").read(tr) is None
    empty = Trace([], [], [(0, 10)], {}, {}, H100)
    assert all(_layer(name).read(empty) is None for name in LAYERS)
