"""The readers of the program's own spans and counters
(``kmer_bench/spans.py`` and the layers that use it) on a synthetic trace
with a stubbed counter registry, each giving None where its span or
counter is absent; then small traced runs on the CPU, whose lines carry
the new metrics of their cell (the card's idle gaps, and their labels,
exist only on the card)."""

import pytest

from conftest import ROOT, run_small

from kmer_bench import run
from kmer_bench.trace import Trace
from kmers_tpu_torch.utils import profiling

#: the new readers and what each reads
SPAN_READERS = {"join_ms.reads": "kmers.join", "wait_ms.reads": "kmers.wait", "wait_ms.count": "kmers.wait",
                "wait_ms.sketch": "kmers.wait", "upload_ms.sketch": "kmers.upload"}
NEW = [*SPAN_READERS, "d2h_gbps.count", "exchange_pad.count"]


def _layer(name):
    return run._load(ROOT / "kmer_bench" / "layers" / f"{name}.py", f"layer_{name}")


def span_trace() -> Trace:
    """Two calls of 1000 us each; in us: a join of 100 and 60, waits of 5 +
    7 and 9 (one nested in a fold), uploads of 30 and 50, downloads of 200
    and 300, an exchange of 40, and a wait that starts before the window."""
    host = [
        ("kb.call", 0, 1000), ("kmers.count_bytes", 2, 990), ("kmers.upload", 3, 33), ("kmers.join", 40, 140),
        ("kmers.wait", 150, 155), ("kmers.fold", 160, 200), ("kmers.wait", 190, 197), ("kmers.exchange", 300, 340),
        ("kmers.download", 500, 700), ("kb.call", 1000, 2000), ("kmers.upload", 1010, 1060),
        ("kmers.join", 1100, 1160), ("kmers.wait", 1200, 1209), ("kmers.download", 1300, 1600),
    ]
    return Trace([], host + [("kmers.wait", -50, 10)], [(0, 1000), (1000, 2000)])


@pytest.fixture
def registry(monkeypatch):
    """A stubbed counter registry: ``registry.update(...)`` sets what
    ``counters()`` returns."""
    totals = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(totals))
    return totals


def test_span_readers_sum_their_span_per_call(registry):
    tr = span_trace()
    # the wait that began before the window counts from the window's start
    want = {"kmers.join": 0.08, "kmers.wait": (5 + 7 + 9 + 10) / 2e3, "kmers.upload": 0.04}
    for name, span in SPAN_READERS.items():
        assert _layer(name).read(tr) == pytest.approx(want[span]), name


def test_download_rate_from_the_byte_counter(registry):
    registry.update(download_bytes=1_000_000)
    # 1e6 bytes over 2 calls, 250 us a call: 2 GB/s
    assert _layer("d2h_gbps.count").read(span_trace()) == pytest.approx(2.0)


def test_exchange_padding_from_the_row_counters(registry):
    registry.update(exchange_rows=8_000, exchange_rows_real=2_500)
    assert _layer("exchange_pad.count").read(span_trace()) == pytest.approx(3.2)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_without_its_span_or_counter_gives_none(registry, name):
    empty = Trace([], [("kb.call", 0, 1000)], [(0, 1000)])
    assert _layer(name).read(empty) is None
    # the spans, but no counter
    if name in ("d2h_gbps.count", "exchange_pad.count"):
        assert _layer(name).read(span_trace()) is None
    if name == "exchange_pad.count":
        # no real row: no ratio
        registry.update(exchange_rows=10, exchange_rows_real=0)
        assert _layer(name).read(span_trace()) is None


def test_a_program_that_keeps_no_counters_gives_none(monkeypatch):
    from kmer_bench.spans import counter

    monkeypatch.delattr(profiling, "counters")
    assert counter(span_trace(), "download_bytes") is None
    assert _layer("d2h_gbps.count").read(span_trace()) is None


@pytest.mark.parametrize("cell, metrics", [
    ("jellyfish_k31.chr21", {"wait_ms.count", "d2h_gbps.count"}),
    ("jellyfish_k31.reads30x", {"join_ms.reads", "wait_ms.reads"}),
    ("mash_k21_s1000.bacteria", {"wait_ms.sketch", "upload_ms.sketch"}),
])
def test_a_traced_run_carries_the_new_metrics(cell, metrics):
    profiling.reset_counters()
    _, line = run_small(cell, trace=True)
    assert line["correct"]
    assert metrics <= set(line["metrics"])
    assert all(line["metrics"][m]["value"] > 0 for m in metrics)
