"""The word cell ``spades_k55.chr21`` on the CPU, cut here to a size the
CPU runs in seconds (chunks of 2^14 bases, so the word fold runs): the word
reference against brute-force Python ints, a sound run reads ``correct``
true with no forbidden module loaded, the control and each planted fault
read false, the row comparison counts exactly, and the five readers on a
synthetic trace."""

import collections
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import ROOT

from kmer_bench import run
from kmer_bench.reference import words as ref
from kmer_bench.trace import Trace

cc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")

CELL = "spades_k55.chr21"
#: the cell cut for the CPU: 300 kb in chunks of 2^14 bases, with 2 of the
#: 20 N blocks, so that N covers a few % of it as it does of the whole
#: chromosome (a changed base inside an N block changes no window)
SMALL = {"config": {"chunk_size": 1 << 14},
         "traffic": {"bases": 300_000, "big_n_block": 15_000, "low_complexity": 20_000, "n_blocks": 2}}
LAYERS = ["k3_roofline.words", "sort_ms.words", "fold_ms.words", "resort_rows.words", "idle_pct.words"]


def small_cell():
    cell = run.resolve(CELL)
    for key in ("config", "traffic"):
        getattr(cell, key).update(SMALL[key])
    return cell


def run_small(seed=2**31 + 23, seconds=0.3, trace=False, **kw):
    cell = small_cell()
    out = run.run_cell(cell, seed, seconds, trace, "cpu", time.time(), log=lambda msg: None, **kw)
    return run.result_line(cell, out, trace)


# -- the reference ------------------------------------------------------------

_CODE = {ord(c): i for i, c in enumerate("ACGT")} | {ord("U"): 3}


def brute_table(seq: bytes, k: int):
    """Canonical registers as Python ints, split at bit 62, counted."""
    table = collections.Counter()
    for p in range(len(seq) - k + 1):
        w = seq[p : p + k].upper()
        if any(b not in _CODE for b in w):
            continue
        fwd = rc = 0
        for j, b in enumerate(w):
            fwd = (fwd << 2) | _CODE[b]
            rc |= (3 - _CODE[b]) << (2 * j)
        reg = min(fwd, rc)
        table[(reg >> 62, reg & ((1 << 62) - 1))] += 1
    return table


def _sequence(seed: int, n: int = 4_000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTacgtUu", np.uint8)[rng.integers(0, 10, n)].copy()
    seq[n // 3 : n // 3 + 400] = ord("A")
    seq[n // 2 : n // 2 + 30] = ord("N")
    seq[rng.integers(0, n, 5)] = np.frombuffer(b"RYKMS", np.uint8)
    seq[3 * n // 4 : 3 * n // 4 + 200] = seq[100:300]
    return seq


@pytest.mark.parametrize("k", [32, 55, 62])
def test_the_reference_is_brute_force(k):
    seq = _sequence(k)
    rows, counts = ref.count_table(seq, k)
    want = brute_table(seq.tobytes(), k)
    assert [tuple(r) for r in rows.tolist()] == sorted(want)
    assert counts.tolist() == [want[r] for r in sorted(want)] and max(counts.tolist()) > 1


@pytest.mark.parametrize("k", [32, 55, 62])
def test_a_changed_base_is_applied_as_brute_force_says(k):
    seq = _sequence(100 + k)
    rows, counts = ref.count_table(seq, k)
    for pos, new in ((0, ord("C")), (1_000, ord("G")), (seq.size - 1, ord("T")), (seq.size // 2 + 10, ord("A"))):
        after = seq.copy()
        after[pos] = new
        minus, plus = ref.window_rows(seq, pos, k), ref.window_rows(after, pos, k)
        got_r, got_c = ref.apply_delta(rows, counts, minus, plus)
        want = brute_table(after.tobytes(), k)
        assert [tuple(r) for r in got_r.tolist()] == sorted(want)
        assert got_c.tolist() == [want[r] for r in sorted(want)]


def test_the_seam_control_counts_each_seam_window_twice():
    seq, k, chunk = _sequence(5, 6_000), 55, 1_000
    rows, counts = ref.count_table(seq, k)
    got_r, got_c = ref.count_table_seam_double(seq, k, chunk)
    seams = range(chunk - k, seq.size - k + 1, chunk - k)
    valid = [np.isin(seq[s : s + k], list(b"ACGTUacgtu")).all() for s in seams]
    assert 0 < sum(valid) < len(valid)
    assert got_r.shape == rows.shape and got_c.sum() - counts.sum() == sum(valid)
    with pytest.raises(ValueError):
        ref.count_table(seq, 31)


# -- the comparison that decides ``correct`` --------------------------------

def _entry():
    return run.resolve(CELL).entry


def test_rows_wrong_counts_rows_exactly():
    rows_wrong = _entry().rows_wrong
    want_w = np.array([[0, 5], [1, 2], [1, 9], [7, 0]], np.uint64)
    want_c = np.array([3, 1, 2, 1], np.int64)
    assert rows_wrong(want_w.copy(), want_c.copy(), want_w, want_c) == 0
    assert rows_wrong(want_w[1:], want_c[1:], want_w, want_c) == 1  # a dropped row
    off = want_c.copy()
    off[2] += 1
    assert rows_wrong(want_w, off, want_w, want_c) == 2  # a wrong row, a missing row
    extra = np.insert(want_w, 2, [1, 5], axis=0)
    assert rows_wrong(extra, np.insert(want_c, 2, 1), want_w, want_c) == 1
    dup = np.insert(want_w, 1, want_w[1], axis=0)
    assert rows_wrong(dup, np.insert(want_c, 1, 1), want_w, want_c) == 1  # a repeated row
    swapped = want_w[:, ::-1].copy()
    assert rows_wrong(swapped, want_c, want_w, want_c) == 8
    assert rows_wrong(want_w.astype(np.int64), want_c, want_w, want_c) == 8
    assert rows_wrong(want_w.reshape(-1), want_c, want_w, want_c) == 8


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    line = run_small(trace=trace)
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    assert line["check"] == {"rows_wrong": {"value": 0, "limit": 0}}
    if trace:
        # on the CPU only the program's counter has something to read
        assert set(line["metrics"]) == {"resort_rows.words"}
        assert 2 < line["metrics"]["resort_rows.words"]["value"] < 8
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
        words, counts = fn(*a, **kw)
        return words[:-1], counts[:-1]

    return drop


def _count_off_by_one(fn):
    def bump(*a, **kw):
        words, counts, n = fn(*a, **kw)
        counts = counts.clone()
        counts[0] += 1
        return words, counts, n

    return bump


FAULTS = [
    ("state unchanged", "count_stream", _stale),
    ("a row dropped", "_count_words", _drop_last_row),
    ("a count off by one", "merge_compact_tables_mw", _count_off_by_one),
]


@pytest.mark.parametrize("fault,attr,plant", FAULTS, ids=[f[0] for f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, attr, plant):
    monkeypatch.setattr(cc, attr, plant(getattr(cc, attr)))
    line = run_small()
    assert not line["correct"], fault


DRIVE = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from test_kbench_words import run_small
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
    assert cell.chips == 1 and cell.config["K"] == 55 and cell.config["chunk_size"] == 1 << 19
    assert cell.traffic["entry"] == "count_words" and cell.config["reduced"] == []
    assert [n for n, _, _ in cell.end_to_end] == ["setup_s", "bases_per_s"]
    assert [n for n, _, _ in cell.per_layer] == LAYERS
    chr21 = json.loads((ROOT / "kmer_bench" / "traffic" / "chr21.json").read_text())
    assert {k: v for k, v in cell.traffic.items() if k not in ("entry", "why")} == \
        {k: v for k, v in chr21.items() if k not in ("entry", "why")}


H100 = "NVIDIA H100 80GB HBM3"


def _layer(name):
    return run._load(ROOT / "kmer_bench" / "layers" / f"{name}.py", f"layer_{name}")


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    """Two calls of 1000 us; device time in us: K3 10 + 10, radix sort 40,
    K2 6, K10 12, searchsorted 5, D2H 300, K1 3 (not K3's)."""
    dev = [
        ("void (anonymous namespace)::canonical_windows_mw_kernel<2>(unsigned char const*, long, int, long*, unsigned long long*)", 0, 10),
        ("void (anonymous namespace)::canonical_windows_mw_kernel<2>(unsigned char const*, long, int, long*, unsigned long long*)", 1000, 1010),
        ("void cub::DeviceRadixSortOnesweepKernel<...>", 20, 60), ("rle_unit_kernel(long const*, long)", 60, 66),
        ("compact_scatter_kernel(long const*, long const*, long, int)", 110, 122),
        ("void at::native::searchsorted_cuda_kernel<long>", 130, 135),
        ("Memcpy DtoH (Device -> Pinned)", 600, 900),
        ("void canonical_windows_kernel<false>(unsigned char const*, long, int, long*, unsigned long long*)", 1100, 1103),
    ]
    tr = Trace(dev, [], [(0, 1000), (1000, 2000)], {}, {"k3_positions": 2_000_000, "bases": 2_000_000}, H100)
    assert _layer("k3_roofline.words").read(tr) == pytest.approx(100 * 17 * 2e6 / 3.35e12 / 20e-6)
    assert _layer("sort_ms.words").read(tr) == pytest.approx(0.023)
    assert _layer("fold_ms.words").read(tr) == pytest.approx(0.0085)
    busy = 10 + 10 + 40 + 6 + 12 + 5 + 300 + 3
    assert _layer("idle_pct.words").read(tr) == pytest.approx(100 * (1 - busy / 2000))
    from kmers_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"mw_sort_rows": 15_000_000})
    assert _layer("resort_rows.words").read(tr) == pytest.approx(7.5)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _layer("resort_rows.words").read(tr) is None
    empty = Trace([], [], [(0, 10)], {}, {}, H100)
    assert all(_layer(name).read(empty) is None for name in LAYERS)
