"""The readers of the roots' self time, the pinned allocations and the
file read (``kmer_bench/self_time.py``, ``self_ms.*``, ``pin_ms.bases``,
``pin_miss.bases``, ``read_ms.reads``) on a synthetic trace with a stubbed
counter registry, each giving None where its span or counter is absent;
then small traced runs on the CPU (no pinned memory there, so the pinned
readers give None)."""

import pytest

from conftest import ROOT, run_small

from kmer_bench import run
from kmer_bench.self_time import self_ms
from kmer_bench.trace import Trace
from kmers_tpu_torch.utils import profiling

NEW = ["self_ms.bases", "self_ms.sketch", "pin_ms.bases", "pin_miss.bases", "read_ms.reads"]


def _layer(name):
    return run._load(ROOT / "kmer_bench" / "layers" / f"{name}.py", f"layer_{name}")


def self_trace() -> Trace:
    """A window of 100-2000 us over two calls.  The first root (50-900)
    and its upload (60-160) straddle the window's start; a drain (200-400)
    holds a fold (250-350) and overlaps a cut (380-450).  The second root
    (1010-2100) holds a wait (1100-1150) and a pin (1900-2100) across the
    window's end.  Operators and the harness's spans are not the
    program's."""
    host = [
        ("kb.call", 100, 1000), ("kmers.count_bytes", 50, 900), ("kmers.upload", 60, 160),
        ("aten::sort", 170, 190), ("kmers.drain", 200, 400), ("kmers.fold", 250, 350), ("kmers.rows", 380, 450),
        ("kb.call", 1000, 2000), ("kmers.count_bytes", 1010, 2100), ("kb.parse", 1020, 1090),
        ("kmers.wait", 1100, 1150), ("kmers.pin", 1900, 2100),
    ]
    return Trace([], sorted(host, key=lambda x: (x[1], -x[2])), [(100, 1000), (1000, 2000)])


@pytest.fixture
def registry(monkeypatch):
    """A stubbed counter registry: ``registry.update(...)`` sets what
    ``counters()`` returns."""
    totals = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(totals))
    return totals


def test_self_time_is_the_root_outside_the_union_of_its_children():
    # root 1: 800 us in the window, children cover 60 + (200-450) = 310;
    # root 2: 990 us in the window, children cover 50 + 100
    assert self_ms(self_trace()) == pytest.approx(((800 - 310) + (990 - 150)) / 2e3)
    for name in ("self_ms.bases", "self_ms.sketch"):
        assert _layer(name).read(self_trace()) == pytest.approx(0.665)


def test_a_root_without_children_is_all_self_time():
    tr = Trace([], [("kb.call", 0, 1000), ("kmers.sketch", 10, 510), ("aten::topk", 20, 400)], [(0, 1000)])
    assert self_ms(tr) == pytest.approx(0.5)


def test_a_child_that_opens_with_its_root_is_not_a_root():
    tr = Trace([], [("kb.call", 0, 1000), ("kmers.sixframe", 0, 800), ("kmers.upload", 0, 300)], [(0, 1000)])
    assert self_ms(tr) == pytest.approx(0.5)


def test_pinned_time_and_the_new_share(registry):
    tr = self_trace()
    # the pin is clipped at the window's end: 100 us over two calls
    assert _layer("pin_ms.bases").read(tr) == pytest.approx(0.05)
    registry.update(pinned_bytes=1000, pinned_new_bytes=250)
    assert _layer("pin_miss.bases").read(tr) == pytest.approx(25.0)
    registry.update(pinned_new_bytes=0)
    assert _layer("pin_miss.bases").read(tr) == 0.0


def test_the_read_time_per_job():
    tr = Trace([], [("kb.call", 0, 1000), ("kmers.parse", 10, 400), ("kmers.read", 20, 220)], [(0, 1000)])
    assert _layer("read_ms.reads").read(tr) == pytest.approx(0.2)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_without_its_span_or_counter_gives_none(registry, name):
    empty = Trace([], [("kb.call", 0, 1000), ("aten::sort", 10, 20)], [(0, 1000)])
    assert _layer(name).read(empty) is None
    assert _layer(name).read(Trace([], [], [])) is None
    if name == "pin_miss.bases":
        # the spans, but no counter; then no byte asked for
        assert _layer(name).read(self_trace()) is None
        registry.update(pinned_bytes=0, pinned_new_bytes=0)
        assert _layer(name).read(self_trace()) is None


@pytest.mark.parametrize("cell, present, absent", [
    ("jellyfish_k31.chr21", {"self_ms.bases"}, {"pin_ms.bases", "pin_miss.bases"}),
    ("mash_k21_s1000.bacteria", {"self_ms.sketch"}, set()),
    ("jellyfish_k31.reads30x", {"read_ms.reads"}, set()),
])
def test_a_traced_run_carries_the_new_metrics(cell, present, absent):
    profiling.reset_counters()
    _, line = run_small(cell, trace=True)
    assert line["correct"]
    assert present <= set(line["metrics"]) and not absent & set(line["metrics"])
    assert all(line["metrics"][m]["value"] > 0 for m in present)
    if cell == "jellyfish_k31.reads30x":
        # the file read lies inside the harness's parse span
        assert line["metrics"]["read_ms.reads"]["value"] <= line["metrics"]["parse_ms.reads"]["value"]
