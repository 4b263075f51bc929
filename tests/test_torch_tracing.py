"""The port's spans and counters (``kmers_tpu_torch/utils/profiling.py``)
on the CPU: each public call of the count, stream, sketch and sharded paths
records its ``kmers.*`` spans, nested under the call's root span, while a
torch profiler records; its counters count the bytes and rows moved; and
with no profiler running neither a span nor a counter is touched."""

import collections
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmers_tpu_torch import (
    CountConfig, SixFrameCountConfig, StreamingSketcher, canonical_count_bytes, count_fastx_stream,
    minhash_sketch, minimizer_select, sixframe_aa_count,
)
from kmers_tpu_torch import parallel as par
from kmers_tpu_torch.io import native, stream_fastx
from kmers_tpu_torch.ops import count as count_ops
from kmers_tpu_torch.ops import multiword
from kmers_tpu_torch.parallel.pipeline import _shard_with_halo
from kmers_tpu_torch.pipelines import extract as extract_pipe
from kmers_tpu_torch.utils import profiling
from kmers_tpu_torch.utils.profiling import count, counters, reset_counters

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from reference import sixframe_aa  # noqa: E402

K = 15
#: 3 chunks of 1000 bases overlapping by K - 1
DATA = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(0).integers(0, 4, 2500)]
CC = CountConfig(K=K, chunk_size=1000)


def _traced(fn):
    """``(fn(), spans, counters)`` under a CPU profiler: ``spans`` are
    ``(name, parent, start, end)`` of the ``kmers.*`` host events in start
    order, ``parent`` the innermost ``kmers.*`` span around each (None for
    a root)."""
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events() if e.name().startswith("kmers.")),
        key=lambda x: (x[1], -x[2]),
    )
    spans, stack = [], []
    for name, s, e in events:
        while stack and stack[-1][2] < e:
            stack.pop()
        spans.append((name, stack[-1][0] if stack else None, s, e))
        stack.append((name, s, e))
    return out, spans, counters()


def _children(spans, parent):
    return [n for n, p, _, _ in spans if p == parent]


@pytest.fixture
def merged(monkeypatch):
    """The summed lengths of the tables each call of K9's merge-reduce
    (``merge_reduce_tables``, the one-word fold) and of its word instance
    (``merge_tables_mw``) was given, by name."""
    rows = {"merge_rows": 0, "mw_merge_rows": 0}

    def spy(name, fn):
        def merge(ka, ca, kb, cb):
            rows[name] += ca.shape[0] + cb.shape[0]
            return fn(ka, ca, kb, cb)
        return merge

    monkeypatch.setattr(count_ops, "merge_reduce_tables", spy("merge_rows", count_ops.merge_reduce_tables))
    monkeypatch.setattr(multiword, "merge_tables_mw", spy("mw_merge_rows", multiword.merge_tables_mw))
    return rows


def test_count_bytes_records_its_layers_under_one_root(merged):
    (kmers, _), spans, totals = _traced(lambda: canonical_count_bytes(DATA, CC, device="cpu"))
    assert [n for n, p, _, _ in spans if p is None] == ["kmers.count_bytes"]
    kids = _children(spans, "kmers.count_bytes")
    assert kids.count("kmers.upload") == 1 and kids.count("kmers.chunk") == 3
    # three chunk tables drained; the second push merges, the final fold merges once more
    assert kids.count("kmers.drain") == 3 and _children(spans, "kmers.drain") == ["kmers.fold"]
    assert kids.count("kmers.fold") == 1 and kids.count("kmers.download") == 2
    # each fold holds its distinct count's read; the drain queue reads once a chunk
    assert _children(spans, "kmers.fold") == ["kmers.wait", "kmers.wait"]
    assert kids.count("kmers.wait") == 3
    # K9 merged the three chunk tables in two merges
    assert merged["merge_rows"] > 0
    assert totals == {"upload_bytes": DATA.size, "download_bytes": kmers.size * 16,
                      "merge_rows": merged["merge_rows"]}


def test_count_bytes_at_k31_counts_the_rows_k9_merges(merged):
    (kmers, counts), _, totals = _traced(
        lambda: canonical_count_bytes(DATA, CountConfig(K=31, chunk_size=1000), device="cpu"))
    # three chunk tables of distinct 31-mers: 970 + 970 rows, then 1940 + 530
    assert merged["merge_rows"] == 2 * 970 + (2 * 970 + 530) == counts.sum() + 2 * 970
    assert totals["merge_rows"] == merged["merge_rows"] and "aa_windows" not in totals


#: six-frame input: 6 chunks of 1000 bases overlapping by 3K - 1 at K = 7,
#: with an N block, a soft-masked run and an IUPAC code
DATA_AA = DATA[np.random.default_rng(4).integers(0, DATA.size, 5_000)].copy()
DATA_AA[1_200:1_300] = ord("N")
DATA_AA[3_000:3_400] |= 0x20
DATA_AA[4_321] = ord("R")


@pytest.mark.parametrize("K", [7, 12])
def test_sixframe_records_its_layers_under_one_root(merged, K):
    cfg = SixFrameCountConfig(K=K, chunk_size=1000)
    (kmers, counts), spans, totals = _traced(lambda: sixframe_aa_count(DATA_AA, cfg, device="cpu"))
    assert [n for n, p, _, _ in spans if p is None] == ["kmers.sixframe"]
    kids = _children(spans, "kmers.sixframe")
    n_chunks = len(range(0, DATA_AA.size - 3 * K + 1, 1000 - (3 * K - 1)))
    assert n_chunks >= 5 and kids.count("kmers.chunk") == n_chunks
    folds = kids.count("kmers.fold") + _children(spans, "kmers.drain").count("kmers.fold")
    assert kids.count("kmers.upload") == 1 and folds == n_chunks - 1
    assert kids.count("kmers.drain") == n_chunks and kids.count("kmers.download") == 2
    # the windows counted are the reference's, and the fold's rows are the merges'
    assert totals["aa_windows"] == int(sixframe_aa.count_table(DATA_AA, K)[1].sum()) == counts.sum()
    rows = "merge_rows" if K <= 7 else "mw_merge_rows"
    assert merged[rows] > 0 and totals[rows] == merged[rows]
    assert set(totals) == {"upload_bytes", "download_bytes", "aa_windows", rows, *(("mw_sort_rows",) if K > 7 else ())}


def test_count_bytes_one_chunk_and_multiword_routes():
    (_, _), spans, _ = _traced(lambda: canonical_count_bytes(DATA[:900], CC, device="cpu"))
    assert _children(spans, "kmers.count_bytes") == [
        "kmers.upload", "kmers.chunk", "kmers.wait", "kmers.rows", "kmers.download", "kmers.download"]
    (kmers, _), spans, totals = _traced(
        lambda: canonical_count_bytes(DATA, CountConfig(K=40, chunk_size=1000), device="cpu"))
    kids = _children(spans, "kmers.count_bytes")
    assert kids.count("kmers.chunk") == 3 and kids.count("kmers.drain") == 3
    assert kids.count("kmers.fold") + _children(spans, "kmers.drain").count("kmers.fold") == 2
    # the packed words are boxed into Python ints last
    assert kids[-1] == "kmers.words"
    # every column of the chunks of 1000, 1000 and 578 bytes is sorted once;
    # the merges take their two sorted tables: 961 + 961 rows, then 1922 + 539
    sorted_rows = 1000 + 1000 + 578
    merged_rows = 2 * 961 + (2 * 961 + 539)
    # two int64 words a 40-mer and a count
    assert totals == {"upload_bytes": DATA.size, "download_bytes": kmers.size * 24,
                      "mw_sort_rows": sorted_rows, "mw_merge_rows": merged_rows}


def _fastq(path, n_reads=300, read_len=60):
    rng = np.random.default_rng(1)
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n_reads, read_len))]
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * read_len))
    return path


def test_fastx_stream_parses_each_batch_before_its_update(tmp_path):
    path = _fastq(tmp_path / "reads.fq")
    batch = 4096
    n_batches = sum(1 for _ in stream_fastx(path, batch_bytes=batch))
    assert n_batches >= 3
    (kmers, _), spans, totals = _traced(
        lambda: count_fastx_stream(path, CountConfig(K=K, chunk_size=2048), batch_bytes=batch, device="cpu"))
    assert [n for n, p, _, _ in spans if p is None] == ["kmers.count_fastx"]
    kids = [(n, s, e) for n, p, s, e in spans if p == "kmers.count_fastx"]
    names = [n for n, _, _ in kids]
    assert names == ["kmers.parse", "kmers.update"] * n_batches + ["kmers.parse", "kmers.finalize"]
    # each batch's parse span closes before the consumer's update opens
    for (_, _, parse_end), (_, update_start, _) in zip(kids[::2], kids[1::2]):
        assert parse_end <= update_start
    assert _children(spans, "kmers.update").count("kmers.join") == n_batches
    assert totals["download_bytes"] == kmers.size * 16


@pytest.mark.parametrize("native_built", [True, False])
def test_join_native_records_counts_the_records_the_native_join_placed(tmp_path, monkeypatch, native_built):
    path = _fastq(tmp_path / "reads.fq")
    n_records = [off.size - 1 for _, off in stream_fastx(path, batch_bytes=4096)]
    assert len(n_records) >= 3 and min(n_records) > 1
    if not native_built:
        monkeypatch.setattr(native, "library", lambda: None)
    _, _, totals = _traced(
        lambda: count_fastx_stream(path, CountConfig(K=K, chunk_size=2048), batch_bytes=4096, device="cpu"))
    assert totals.get("join_native_records", 0) == (sum(n_records) if native_built else 0)


def test_sketch_records_select_and_its_waits():
    data = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(2).integers(0, 4, 20_000)]
    sketch, spans, totals = _traced(lambda: minhash_sketch(data, K=21, s=100, device="cpu"))
    assert [n for n, p, _, _ in spans if p is None] == ["kmers.sketch"]
    assert _children(spans, "kmers.sketch") == [
        "kmers.upload", "kmers.hash", "kmers.wait", "kmers.select", "kmers.download", "kmers.wait"]
    assert totals == {"upload_bytes": data.size, "download_bytes": sketch.size * 8}


#: minimizer input: ~100 kb with an N block and a soft-masked run, walked
#: in chunks of 2^15 windows (4 chunks)
DATA_MM = DATA[np.random.default_rng(5).integers(0, DATA.size, 100_000)].copy()
DATA_MM[40_000:41_000] = ord("N")
DATA_MM[70_000:72_000] |= 0x20
MM_CHUNK = 1 << 15


def _minimum_rows(n_win: int, W: int, chunk: int) -> int:
    """The rows the doubling sliding minimum's combines write over the
    walk's chunks: ``n - span`` each doubling round over the chunk's ``n``
    k-mers, then the chunk's windows."""
    total = 0
    for s in range(0, n_win, chunk):
        windows = min(chunk, n_win - s)
        n, span = windows + W - 1, 1
        while span * 2 <= W:
            n -= span
            total += n
            span *= 2
        total += windows
    return total


def test_minimizers_record_their_chunks_under_one_root(monkeypatch):
    monkeypatch.setattr(extract_pipe, "MINIMIZER_CHUNK_WINDOWS", MM_CHUNK)
    (values, positions), spans, totals = _traced(
        lambda: minimizer_select(DATA_MM, K=15, W=10, skip_ambiguous=True, device="cpu"))
    n_win = DATA_MM.size - 15 - 10 + 2
    n_chunks = -(-n_win // MM_CHUNK)
    assert n_chunks >= 3 and positions.size > 0
    assert [n for n, p, _, _ in spans if p is None] == ["kmers.minimizers"]
    # the root encloses every chunk, minimum and wait span of the call
    assert _children(spans, "kmers.minimizers") == (
        ["kmers.upload"] + ["kmers.chunk"] * n_chunks + ["kmers.wait", "kmers.download", "kmers.download"])
    assert _children(spans, "kmers.chunk") == ["kmers.minimum", "kmers.wait"] * n_chunks
    assert totals["minimizer_windows"] == n_win
    assert totals["minimum_rows"] == _minimum_rows(n_win, 10, MM_CHUNK) == 4 * n_win + 16 * n_chunks
    # the rows returned are the arrays' length: no counter repeats them
    assert set(totals) == {"upload_bytes", "download_bytes", "minimizer_windows", "minimizer_kernel_windows",
                           "minimum_rows"}
    assert totals["download_bytes"] == values.nbytes + positions.nbytes


def test_an_unprofiled_minimizer_call_records_nothing(monkeypatch):
    reset_counters()
    monkeypatch.setattr(profiling, "record_function", _no_record_function)
    monkeypatch.setattr(extract_pipe, "MINIMIZER_CHUNK_WINDOWS", MM_CHUNK)
    minimizer_select(DATA_MM, K=15, W=10, skip_ambiguous=True, device="cpu")
    par.sharded_minimizer_select(DATA_MM, K=15, W=10, mesh=par.data_mesh(2, device="cpu"), skip_ambiguous=True)
    assert counters() == {}


def test_streaming_sketcher_update_is_a_root_span():
    data = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, 5_000)]
    sketcher = StreamingSketcher(K=21, s=50, chunk_size=2_000, device="cpu")
    _, spans, totals = _traced(lambda: sketcher.update(data))
    assert [n for n, p, _, _ in spans if p is None] == ["kmers.sketch"]
    assert _children(spans, "kmers.sketch").count("kmers.select") == 3
    assert totals["upload_bytes"] == data.size


@pytest.mark.parametrize("chunk_size", [1 << 20, 1000], ids=["one-chunk", "streamed"])
def test_sharded_count_records_the_exchange_and_its_rows(chunk_size):
    mesh = par.data_mesh(2, device="cpu")
    cfg = par.ShardedCountConfig(K=K, chunk_size=chunk_size)
    (kmers, _), spans, totals = _traced(lambda: par.sharded_canonical_count(DATA, cfg, mesh))
    assert [n for n, p, _, _ in spans if p is None] == ["kmers.sharded_count"]
    kids = _children(spans, "kmers.sharded_count")
    assert kids.count("kmers.exchange") == 1 and kids.count("kmers.gather") == 1
    assert kids[:2] == ["kmers.slabs", "kmers.upload"]
    assert kids[-3:] == ["kmers.rows", "kmers.download", "kmers.download"]
    # the mesh's overflow reduction is a blocking read inside the exchange
    assert _children(spans, "kmers.exchange") == ["kmers.wait"]
    # the real rows routed: every rank's local table, slab and halo
    slabs, shard = _shard_with_halo(DATA, 2, K, pad_byte=ord("N"))
    local = [canonical_count_bytes(slab, CountConfig(K=K), device="cpu")[0].size for slab in slabs]
    assert totals["exchange_rows_real"] == sum(local)
    if chunk_size > shard:
        cap = math.ceil(shard * cfg.bucket_factor / 2)
        assert totals["exchange_rows"] == 2 * 2 * cap
    assert totals["upload_bytes"] == slabs.nbytes
    assert totals["download_bytes"] == kmers.size * 16


def _no_record_function(name):
    raise AssertionError(f"record_function({name!r}) entered with no profiler running")


def _no_host_stats():
    raise AssertionError("the pinned allocator's stats read with no profiler running")


#: the spans that name host work inside the roots: the drain of a chunk
#: table, the cut of a table to its real rows, the host slabs, the sketch's
#: hash dispatch, the file read and the scan, the stream's conservation
#: check, and on the card alone a pinned allocation and the drain queue's
#: prefetch
HOST_SPANS = ("kmers.drain", "kmers.rows", "kmers.slabs", "kmers.hash", "kmers.read", "kmers.scan", "kmers.check",
              "kmers.pin", "kmers.prefetch")


def _stream_call(tmp_path):
    path = _fastq(tmp_path / "reads.fq")
    return lambda: count_fastx_stream(path, CountConfig(K=K, chunk_size=2048), batch_bytes=4096, device="cpu")


#: each call, its root, and the host spans it holds other than the drains:
#: ``{(span, parent): count}``, or a function of the call's ``{(span,
#: parent): count}``: every parse reads, and every one but the last, which
#: reads the end of the file, scans
ROOT_CASES = {
    "count_k15": (lambda _: lambda: canonical_count_bytes(DATA, CC, device="cpu"), "kmers.count_bytes",
                  {("kmers.rows", "kmers.count_bytes"): 1}),
    "count_k40": (lambda _: lambda: canonical_count_bytes(DATA, CountConfig(K=40, chunk_size=1000), device="cpu"),
                  "kmers.count_bytes", {("kmers.rows", "kmers.count_bytes"): 1}),
    "sixframe": (lambda _: lambda: sixframe_aa_count(DATA_AA, SixFrameCountConfig(K=7, chunk_size=1000), device="cpu"),
                 "kmers.sixframe", {("kmers.rows", "kmers.sixframe"): 1}),
    "sharded": (lambda _: lambda: par.sharded_canonical_count(
        DATA, par.ShardedCountConfig(K=K, chunk_size=1000), par.data_mesh(2, device="cpu")),
        "kmers.sharded_count", {("kmers.slabs", "kmers.sharded_count"): 1, ("kmers.rows", "kmers.sharded_count"): 1}),
    "sketch": (lambda _: lambda: minhash_sketch(DATA, K=21, s=100, device="cpu"), "kmers.sketch",
               {("kmers.hash", "kmers.sketch"): 1}),
    "stream": (_stream_call, "kmers.count_fastx", {
        ("kmers.rows", "kmers.finalize"): 1, ("kmers.check", "kmers.finalize"): 1,
        ("kmers.read", "kmers.parse"): lambda where: where[("kmers.parse", "kmers.count_fastx")],
        ("kmers.scan", "kmers.parse"): lambda where: where[("kmers.parse", "kmers.count_fastx")] - 1}),
}


@pytest.mark.parametrize("case", ROOT_CASES)
def test_host_spans_nest_under_the_calls_root(case, tmp_path):
    """Each call's host work outside its kernels' spans: one drain a chunk
    table beside its chunk, holding the merges its push sets off; the cut
    to real rows before the download; the sharded slabs; the sketch's
    hash; each batch's file read and scan inside its parse; the stream's
    check."""
    make, root, want = ROOT_CASES[case]
    _, spans, _ = _traced(make(tmp_path))
    assert [n for n, p, _, _ in spans if p is None] == [root]
    where = collections.Counter((n, p) for n, p, _, _ in spans)
    drains = {(n, p): c for (n, p), c in where.items() if n == "kmers.drain"}
    assert drains == {("kmers.drain", p): c for (n, p), c in where.items() if n == "kmers.chunk"}
    want = {key: c(where) if callable(c) else c for key, c in want.items()}
    assert {key: c for key, c in where.items() if key[0] in HOST_SPANS and key[0] != "kmers.drain"} == want
    if case != "sketch":
        # a merge runs inside the drain whose push set it off, or in the final fold
        fold_parents = {p for (n, p) in where if n == "kmers.fold"}
        assert "kmers.drain" in fold_parents and fold_parents <= {"kmers.drain", root, "kmers.finalize"}
    if case == "stream":
        # the read of each batch lies inside its parse, the scan after it
        parses = [(s, e) for n, _, s, e in spans if n == "kmers.parse"]
        reads = [(s, e) for n, _, s, e in spans if n == "kmers.read"]
        scans = [(s, e) for n, _, s, e in spans if n == "kmers.scan"]
        assert len(reads) == len(parses) and all(ps <= rs and re_ <= pe for (ps, pe), (rs, re_) in zip(parses, reads))
        assert all(re_ <= ss and se <= pe for (_, pe), (_, re_), (ss, se) in zip(parses, reads, scans))


def test_a_drain_holds_every_merge_its_pushes_set_off():
    """Four chunk tables: the second push merges once and the fourth
    twice (the level stack's carries), all inside their drains, and the
    final fold has nothing left to merge."""
    data = DATA[np.random.default_rng(6).integers(0, DATA.size, 3_900)]
    (_, counts), spans, _ = _traced(lambda: canonical_count_bytes(data, CC, device="cpu"))
    kids = _children(spans, "kmers.count_bytes")
    assert kids.count("kmers.chunk") == kids.count("kmers.drain") == 4
    assert "kmers.fold" not in kids and _children(spans, "kmers.drain") == ["kmers.fold"] * 3
    assert counts.sum() == data.size - K + 1


def _cpu_pinned(monkeypatch):
    """``torch.empty_like`` without the pinning (no card here), counting its
    pinned requests."""
    real, asked = torch.empty_like, []

    def empty_like(t, *args, pin_memory=False, **kwargs):
        if pin_memory:
            asked.append(t.nbytes)
        return real(t, *args, **kwargs)

    monkeypatch.setattr(torch, "empty_like", empty_like)
    return asked


@pytest.mark.parametrize("growth", [0, 4096], ids=["cached", "pinned anew"])
def test_pinned_new_bytes_is_the_growth_of_the_allocators_stats(monkeypatch, growth):
    asked = _cpu_pinned(monkeypatch)
    totals = iter([1 << 20, (1 << 20) + growth])
    reads = []

    def stats():
        reads.append(1)
        return {"allocated_bytes": {"allocated": next(totals)}}

    monkeypatch.setattr(torch.cuda, "host_memory_stats_as_nested_dict", stats)
    t = torch.zeros(3, 5, dtype=torch.int64)
    host, spans, got = _traced(lambda: profiling.pinned_empty_like(t))
    assert host.shape == t.shape and host.dtype == t.dtype and asked == [t.nbytes]
    assert [(n, p) for n, p, _, _ in spans] == [("kmers.pin", None)] and len(reads) == 2
    assert got == {"pinned_bytes": t.nbytes, "pinned_new_bytes": growth}


def test_an_unprofiled_pinned_allocation_reads_no_stats(monkeypatch):
    reset_counters()
    asked = _cpu_pinned(monkeypatch)
    monkeypatch.setattr(profiling, "record_function", _no_record_function)
    monkeypatch.setattr(torch.cuda, "host_memory_stats_as_nested_dict", _no_host_stats)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", _no_host_stats)
    profiling.pinned_empty_like(torch.zeros(7))
    assert asked == [28] and counters() == {}


def test_every_pinned_allocation_of_the_port_passes_one_helper():
    package = ROOT / "kmers_tpu_torch"
    users = sorted(str(p.relative_to(package)) for p in package.rglob("*.py") if "pin_memory" in p.read_text())
    assert users == ["utils/profiling.py"]


def test_nothing_is_recorded_without_a_profiler(monkeypatch, tmp_path):
    reset_counters()
    monkeypatch.setattr(profiling, "record_function", _no_record_function)
    monkeypatch.setattr(torch.cuda, "host_memory_stats_as_nested_dict", _no_host_stats)
    canonical_count_bytes(DATA, CC, device="cpu")
    count_fastx_stream(_fastq(tmp_path / "reads.fq"), CC, batch_bytes=4096, device="cpu")
    minhash_sketch(DATA, K=K, s=20, device="cpu")
    sixframe_aa_count(DATA_AA, SixFrameCountConfig(K=7, chunk_size=1000), device="cpu")
    par.sharded_canonical_count(DATA, par.ShardedCountConfig(K=K, chunk_size=1000), par.data_mesh(2, device="cpu"))
    assert counters() == {}


def test_a_lazy_counter_value_is_computed_only_while_recording():
    reset_counters()
    count("rows", lambda: pytest.fail("computed with no profiler running"))
    assert counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        count("rows", lambda: torch.tensor(3))
        count("rows", torch.tensor(4))
        count("rows", 5)
    assert counters() == {"rows": 12}
    reset_counters()
    assert counters() == {}


def test_the_gate_is_the_profilers_own_state():
    # a private torch function: if an upgrade moves it, the spans must not
    # silently turn off
    gate = torch._C._autograd._profiler_enabled
    assert profiling._profiler_enabled is gate
    assert gate() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert gate() is True
    with torch.autograd.profiler.profile():
        assert gate() is True
    assert gate() is False
