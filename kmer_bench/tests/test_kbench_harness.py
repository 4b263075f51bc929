"""The harness on the CPU: every cell resolves to its files, a cell added as
new files is found without an edit, ``BENCHMARK.json`` keeps to the
contract's names, units and limits, the result line has exactly its keys,
the layer readers' kernel-name grouping and roofline arithmetic on a
synthetic trace, the end-to-end readers on a synthetic window, four gloo
ranks in four processes, and the command's refusal without a card.  The
``cuda`` tests run a short cell on the card."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT, SMALL, run_small

from kmer_bench import run
from kmer_bench.trace import Trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = run.resolve(name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.chips == w["chips"] and cell.config["K"] >= 1
    assert (ROOT / "kmer_bench" / "traffic" / f"{w['traffic']}.json").exists()
    for method in ("warm", "call", "work", "check", "control"):
        assert callable(getattr(cell.entry.Entry, method))
    e2e = [n for n, _, _ in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for _, _, reader in cell.end_to_end + cell.per_layer:
        assert callable(reader.read)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_of_new_files_is_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "kmer_bench", tmp_path / "kmer_bench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = _digests(tmp_path / "kmer_bench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((tmp_path / "kmer_bench" / "traffic" / "chr21.json").read_text())
    traffic.update(bases=400_000, why="a shorter chromosome")
    (tmp_path / "kmer_bench" / "traffic" / "chr4_part.json").write_text(json.dumps(traffic))
    (tmp_path / "kmer_bench" / "layers" / "k2_ms.count.py").write_text(
        "from kmer_bench.trace import group_ms\n\ndef read(tr):\n"
        "    return group_ms(tr, lambda n: 'rle_unit_kernel' in n)\n")
    bench["workloads"].append({"name": "jellyfish_k31.chr4_part", "config": "jellyfish_k31",
                               "traffic": "chr4_part", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "k2_ms.count", "unit": "ms/call", "better": "lower",
                               "source": "device_trace", "layer": "sort", "moves": "bases_per_s",
                               "workloads": ["jellyfish_k31.chr4_part"]})
    next(m for m in bench["end_to_end"] if m["name"] == "bases_per_s")["workloads"].append("jellyfish_k31.chr4_part")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.resolve("jellyfish_k31.chr4_part", tmp_path)
    assert cell.traffic["bases"] == 400_000 and cell.entry.Entry.__module__.endswith("count_bytes")
    assert [n for n, _, _ in cell.end_to_end] == ["setup_s", "bases_per_s"]
    assert [n for n, _, _ in cell.per_layer] == ["k2_ms.count"]
    after = _digests(tmp_path / "kmer_bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024 and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["kmer_bench"] and len(BENCH["command"]) <= 32
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("kmer_bench/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200 and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert NAME.match(w["traffic"]) and w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells and 1 <= len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", [w])]
        assert len(reported) >= 2 and any(w in m["workloads"] for m in BENCH["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "kmer_bench").rglob("*"):
        if "__pycache__" not in p.parts and "_cache" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(p.relative_to(ROOT)))


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_exactly_its_keys(trace):
    cell, line = run_small("jellyfish_k31.chr21", trace=trace)
    keys = LINE_KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == keys and line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"setup_s", "bases_per_s"}
    assert line["check"] == {"rows_wrong": {"value": 0, "limit": 0}}
    assert json.loads(json.dumps(line)) == line


H100 = "NVIDIA H100 80GB HBM3"


def synthetic_trace(card=H100) -> Trace:
    """Two calls of 1000 us each; device time by layer, in us: K1 10 + 10,
    D2H 300 + 300, sort 40 (radix) + 6 (K2) + 4 (bitonic), fold 8 (K9) +
    12 (K10) + 5 (searchsorted), NCCL 30, a memset 1, topk 7, upload 20."""
    dev = [
        ("void canonical_windows_kernel<false>(unsigned char const*, long, int, long*, unsigned long long*)", 0, 10),
        ("void canonical_windows_kernel<false>(unsigned char const*, long, int, long*, unsigned long long*)", 1000, 1010),
        ("Memcpy DtoH (Device -> Pageable)", 600, 900), ("Memcpy DtoH (Device -> Pageable)", 1600, 1900),
        ("void cub::DeviceRadixSortOnesweepKernel<...>", 20, 60), ("rle_unit_kernel(long const*, long)", 60, 66),
        ("void at::native::bitonicSortKVInPlace<...>", 70, 74),
        ("k9_merge_kernel(kmers::MergeSpec, long const*)", 100, 108),
        ("compact_scatter_kernel(long const*, long const*, long, int)", 110, 122),
        ("void at::native::searchsorted_cuda_kernel<long>", 130, 135),
        ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)", 200, 230),
        ("Memset (Device)", 240, 241), ("void at::native::sbtopk::gatherTopK<long>", 250, 257),
        ("Memcpy HtoD (Pageable -> Device)", 1020, 1040),
    ]
    host = [("kb.call", 0, 1000), ("aten::sort", 15, 80), ("kb.call", 1000, 2000), ("aten::copy_", 1590, 1910)]
    return Trace(dev, host, [(0, 1000), (1000, 2000)], {"kb.parse": [0.002, 0.004]},
                 {"k1_positions": 2 * 1_000_000}, card)


def _layer(name):
    return run._load(ROOT / "kmer_bench" / "layers" / f"{name}.py", f"layer_{name}")


def test_layer_readers_group_kernels_by_name():
    tr = synthetic_trace()
    expect = {"d2h_ms.count": 0.3, "h2d_ms.sketch": 0.01, "sort_ms.count": 0.025, "fold_ms.count": 0.0125,
              "fold_ms.reads": 0.0125, "exchange_ms.count": 0.015, "parse_ms.reads": 3.0,
              "select_ms.sketch": (40 + 6 + 4 + 8 + 12 + 5 + 30 + 7) / 2 / 1e3}
    for name, want in expect.items():
        assert _layer(name).read(tr) == pytest.approx(want), name


def test_roofline_share_from_the_byte_count():
    tr = synthetic_trace()
    # 9 B x 2,000,000 positions at 3.35 TB/s = 5.373 us, over 20 us of K1
    want = 100 * 9 * 2e6 / 3.35e12 / 20e-6
    for name in ("k1_roofline.count", "k1_roofline.sketch"):
        assert _layer(name).read(tr) == pytest.approx(want)
    assert _layer("k1_roofline.count").read(synthetic_trace(card="some other card")) is None


def test_idle_share_and_breakdown():
    tr = synthetic_trace()
    busy = 10 + 300 + 40 + 6 + 4 + 8 + 12 + 5 + 30 + 1 + 7 + 10 + 20 + 300
    for name in ("idle_pct.count", "idle_pct.reads", "idle_pct.sketch"):
        assert _layer(name).read(tr) == pytest.approx(100 * (1 - busy / 2000))
    from kmer_bench.trace import breakdown

    b = breakdown(tr)
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", pytest.approx(600e-6)]
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx((2000 - busy) / 1e6)
    assert gaps["host: kb.call"] > 0 and len(b["device_ops"]) <= 10


def test_readers_find_nothing_in_an_empty_trace():
    empty = Trace([], [], [(0, 10)], {}, {}, H100)
    for p in (ROOT / "kmer_bench" / "layers").glob("*.py"):
        assert _layer(p.stem).read(empty) is None, p.stem


def test_end_to_end_readers():
    w = run.Window([(0.5, {"bases": 100, "reads": 2}), (0.25, {"bases": 50, "reads": 1}),
                    (0.25, {"bases": 50, "reads": 1, "sketches": 1})], 1.0, 7.5)
    e2e = lambda n: run._load(ROOT / "kmer_bench" / "e2e" / f"{n}.py", f"e2e_{n}").read(w)
    assert e2e("setup_s") == 7.5 and e2e("bases_per_s") == 200 and e2e("reads_per_s") == 4
    assert e2e("sketches_per_s") == 1 and e2e("sketch_p95_ms") == pytest.approx(475.0)


def test_four_gloo_ranks_in_four_processes():
    code = (
        "import json, sys, time; sys.path.insert(0, %r)\n"
        "from kmer_bench import ranks, run\n"
        "spec = {'cell': 'jellyfish_k31.chr21_4gpu', 'root': %r, 'seed': 2**31 + 5, 'seconds': 0.3,"
        " 'trace': 0, 'device': 'cpu', 'world': 4, 'overrides': %r}\n"
        "out = ranks.launch(spec, time.time())\n"
        "print(json.dumps(run.result_line(run.resolve(spec['cell']), out, False)))\n"
    ) % (str(ROOT), str(ROOT), SMALL["jellyfish_k31.chr21_4gpu"])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["count"] == 4
    assert line["check"]["ranks_disagreeing"] == {"value": 0, "limit": 0}


def _command(cwd, *args):
    return subprocess.run([sys.executable, "-m", "kmer_bench", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0", *args], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})


def test_the_command_refuses_to_run_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == "" and "cuda" in proc.stderr.lower()


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copytree(ROOT / "kmer_bench", tmp_path / "kmer_bench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _command(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(cuda_device, trace):
    proc = subprocess.run([sys.executable, "-m", "kmer_bench", "--workload", "mash_k21_s1000.bacteria",
                           "--seed", str(2**31 + 17), "--seconds", "2", "--trace", trace],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace == "1":
        assert line["device"]["busy_s"] > 0
        assert all(v["value"] <= 100 for k, v in line["metrics"].items() if "roofline" in k)
