"""The host boundary (``kmers_tpu_torch/pipelines/_input.py``): the
download of a result, a count table's layout, and the entries that cross
it.

A CUDA result of at least ``PINNED_MIN_BYTES`` comes back in pinned host
memory from torch's caching host allocator; smaller results and CPU tensors
take ``t.cpu().numpy()``.  Either way the caller gets the array that
``t.cpu().numpy()`` gives: dtype, shape, strides, values, writable.
``download_table`` lays a device table out as the user's arrays, and every
entry records the bytes it uploads and downloads.  The tests marked
``cuda`` skip without a card; run them on a GPU host with
``python -m pytest tests/test_torch_download.py -m cuda --noconftest -o addopts="" -q``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmers_tpu_torch import (
    CountConfig,
    SixFrameCountConfig,
    StreamingCounter,
    canonical_count_bytes,
    extract_kmers,
    merge_counts_device,
    minhash_sketch,
    minimizer_select,
    sixframe_aa_count,
    syncmer_select,
)
from kmers_tpu_torch import parallel as par
from kmers_tpu_torch.parallel.pipeline import _shard_with_halo, _slabs
from kmers_tpu_torch.parallel.sixframe import _sixframe_slabs
from kmers_tpu_torch.pipelines import _input
from kmers_tpu_torch.pipelines._input import PINNED_MIN_BYTES, download, download_table
from kmers_tpu_torch.utils.profiling import counters, reset_counters

MIB = 1 << 20


@pytest.fixture
def cuda():
    # decided inside the fixture, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counted(fn):
    """``(fn(), counters)`` with the counters on (a CPU profiler records)."""
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, counters()


def _same_array(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape and got.strides == want.strides
    assert got.flags.writeable and np.array_equal(got, want)


def _pinned(arr: np.ndarray) -> bool:
    return torch.from_numpy(arr).is_pinned()


# -- CPU --------------------------------------------------------------------


def test_pinned_threshold_is_one_mib():
    assert PINNED_MIN_BYTES == MIB


@pytest.mark.parametrize("nbytes", [0, 8, MIB - 8, MIB, 4 * MIB])
def test_cpu_tensor_takes_cpu_numpy_unchanged(nbytes, monkeypatch):
    """A CPU tensor of any size is ``t.cpu().numpy()``: the tensor's own
    memory (``.cpu()`` of a CPU tensor copies nothing), never a pinned copy."""
    def no_pin(t):
        raise AssertionError("a CPU tensor took the pinned path")

    monkeypatch.setattr(_input, "_download_pinned", no_pin)
    t = torch.arange(nbytes // 8, dtype=torch.int64)
    arr, totals = _counted(lambda: download(t))
    _same_array(arr, t.cpu().numpy())
    assert np.shares_memory(arr, t.numpy()) or nbytes == 0
    assert totals == {"download_bytes": nbytes}


@pytest.mark.parametrize("case", ["table", "words", "masked", "bool"])
def test_cpu_results_keep_dtype_shape_and_counts(case):
    g = torch.Generator().manual_seed(3)
    src = torch.randint(-(2**62), 2**62, (2, 200_000), generator=g)
    t = {"table": src[0], "words": src[:, src[1] > 0], "masked": src[0][src[1] > 0], "bool": src[0] > 0}[case]
    arr, totals = _counted(lambda: download(t))
    _same_array(arr, t.cpu().numpy())
    assert totals == {"download_bytes": t.nbytes}


def test_cpu_count_of_a_large_table_counts_no_pinned_bytes():
    """A pipeline's result of > 1 MiB on the CPU: ``download_bytes`` as
    before, ``download_pinned_bytes`` absent."""
    data = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(5).integers(0, 4, 200_000)]
    (kmers, counts), totals = _counted(lambda: canonical_count_bytes(data, CountConfig(K=31), device="cpu"))
    assert kmers.nbytes >= PINNED_MIN_BYTES
    assert totals == {"upload_bytes": data.size, "download_bytes": kmers.nbytes + counts.nbytes}


@pytest.mark.parametrize("shape", [(0,), (5_000,), (2, 0), (2, 5_000), (4, 3)])
def test_download_table_lays_keys_and_word_planes_out_as_rows(shape):
    """Keys ``(n,)`` come back as ``np.uint64`` ``(n,)``, word planes
    ``(W, n)`` as C-contiguous ``np.uint64`` rows ``(n, W)``, every bit
    kept; counts as ``np.int64``; keys are downloaded first."""
    g = torch.Generator().manual_seed(7)
    keys = torch.randint(-(2**62), 2**62, shape, generator=g)
    counts = torch.randint(1, 1000, shape[-1:], generator=g)
    (kmers, got), totals = _counted(lambda: download_table(keys, counts))
    want = keys.numpy().T
    assert kmers.dtype == np.uint64 and kmers.shape == want.shape and kmers.flags.c_contiguous
    assert np.array_equal(kmers.view(np.int64), want)
    _same_array(got, counts.numpy())
    assert totals == {"download_bytes": keys.nbytes + counts.nbytes}


def _bases(n, seed):
    return np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(seed).integers(0, 4, n)]


DATA = _bases(6_000, 9)


def _mesh2():
    return par.data_mesh(2, device="cpu")


def _merged():
    a = canonical_count_bytes(_bases(3_000, 5), CountConfig(K=21), device="cpu")
    b = canonical_count_bytes(_bases(3_000, 6), CountConfig(K=21), device="cpu")
    # both tables go up: 8 bytes a key and 8 a count
    return lambda: merge_counts_device(*a, *b, device="cpu"), 16 * (a[0].size + b[0].size)


def _minimizer_slabs():
    span = 10 + 15 - 1
    shard = -(-(DATA.size - span + 1) // 2)
    return _slabs(DATA, 2, shard, span - 1, ord("A"))


#: entry -> () -> (the call, the bytes it uploads, int64 words a key of its table)
BOUNDARY = {
    "sixframe_k7": lambda: (lambda: sixframe_aa_count(DATA, SixFrameCountConfig(K=7), device="cpu"),
                            DATA.nbytes, 1),
    "sixframe_k12": lambda: (lambda: sixframe_aa_count(DATA, SixFrameCountConfig(K=12), device="cpu"),
                             DATA.nbytes, 2),
    "extract_kmers": lambda: (lambda: extract_kmers(DATA, K=21, device="cpu"), DATA.nbytes, 1),
    "minimizer_select": lambda: (lambda: minimizer_select(DATA, K=15, W=10, device="cpu"), DATA.nbytes, 1),
    "syncmer_select": lambda: (lambda: syncmer_select(DATA, K=15, s=5, device="cpu"), DATA.nbytes, 1),
    "merge_counts_device": lambda: (*_merged(), 1),
    "sharded_canonical_count_mw": lambda: (
        lambda: par.sharded_canonical_count_mw(DATA, K=47, mesh=_mesh2()),
        _shard_with_halo(DATA, 2, 47, pad_byte=ord("N"))[0].nbytes, 2),
    "sharded_minimizer_select": lambda: (
        lambda: par.sharded_minimizer_select(DATA, K=15, W=10, mesh=_mesh2()), _minimizer_slabs().nbytes, 1),
    "sharded_sixframe_k7": lambda: (
        lambda: par.sharded_sixframe_aa_count(DATA, par.SixFrameCountConfig(K=7), _mesh2()),
        _sixframe_slabs(DATA, 2, 7)[0].nbytes, 1),
    "sharded_sixframe_k12": lambda: (
        lambda: par.sharded_sixframe_aa_count(DATA, par.SixFrameCountConfig(K=12), _mesh2()),
        _sixframe_slabs(DATA, 2, 12)[0].nbytes, 2),
}


@pytest.mark.parametrize("entry", list(BOUNDARY))
def test_entries_cross_the_host_boundary_once_each_way(entry):
    """Each entry uploads through ``upload`` (a sharded one, every local
    rank's slab) and downloads through ``download``: the counters hold the
    bytes of its input and of its result before any boxing into Python
    ints (``W`` int64 words a key)."""
    call, uploaded, W = BOUNDARY[entry]()
    out, totals = _counted(call)
    rows = out[0].size
    want = rows * 8 * W + sum(a.nbytes for a in out[1:])
    assert out[0].dtype == (np.uint64 if W == 1 else object) and rows > 0
    assert totals["upload_bytes"] == uploaded
    assert totals["download_bytes"] == want
    assert "download_pinned_bytes" not in totals


# -- on the card ------------------------------------------------------------


def _cases(dev):
    """The shapes the callers download: a 1-D table of 2^22 rows, a word
    table (``acc[0][:, keep]``), a boolean-masked slice of a table, the
    counts beside them."""
    g = torch.Generator(device=dev).manual_seed(11)
    acc = torch.randint(-(2**62), 2**62, (3, 1 << 22), device=dev, generator=g)
    keep = acc[2] > 0
    return {
        "table": acc[0],
        "words": acc[:2][:, keep],
        "masked": acc[0][keep],
        "counts": (acc[1] & 0xFF)[keep],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["table", "words", "masked", "counts"])
def test_large_result_is_pinned_and_bit_exact(cuda, case):
    t = _cases(cuda)[case]
    arr, totals = _counted(lambda: download(t))
    _same_array(arr, t.cpu().numpy())
    assert _pinned(arr)
    # the pinned allocation counts its bytes; whether it pinned anew depends on the cache
    assert totals.pop("pinned_new_bytes") >= 0
    assert totals == {"download_bytes": t.nbytes, "download_pinned_bytes": t.nbytes, "pinned_bytes": t.nbytes}
    assert _pinned(arr.view(np.uint64)) and np.array_equal(arr.view(np.uint64), t.cpu().numpy().view(np.uint64))


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [8, 8 * 1000, MIB - 8, MIB, MIB + 8, 64 * MIB])
def test_pinned_at_one_mib_and_above_only(cuda, nbytes):
    t = torch.arange(nbytes // 8, dtype=torch.int64, device=cuda)
    arr, totals = _counted(lambda: download(t))
    _same_array(arr, t.cpu().numpy())
    assert _pinned(arr) == (nbytes >= PINNED_MIN_BYTES)
    assert totals.get("download_pinned_bytes", 0) == (nbytes if nbytes >= PINNED_MIN_BYTES else 0)
    assert totals["download_bytes"] == nbytes


@pytest.mark.cuda
def test_values_complete_when_the_producer_was_queued_just_before(cuda):
    src = torch.randint(0, 1 << 40, (1 << 24,), device=cuda)
    want = np.sort(src.cpu().numpy())
    torch.cuda.synchronize()
    for _ in range(3):
        # the sort is queued, not run, when download starts
        got = download(torch.sort(src).values)
        assert _pinned(got) and np.array_equal(got, want)


@pytest.mark.cuda
def test_results_held_at_once_do_not_alias_through_the_cache(cuda):
    """Results held together, their sources freed, then two of them freed
    and new tensors of their sizes downloaded (the cache hands the freed
    blocks out again): each array still equals its own reference."""
    sizes = [1 << 21, 1 << 21, 3 << 19, 1 << 22]
    srcs = [torch.randint(-(2**62), 2**62, (n,), device=cuda) for n in sizes]
    refs = [s.cpu().numpy().copy() for s in srcs]
    held = [download(s) for s in srcs]
    del srcs
    assert len({a.ctypes.data for a in held}) == len(held)
    for i in (0, 2):
        held[i] = None
        fresh = torch.full((sizes[i],), -i - 1, dtype=torch.int64, device=cuda)
        held[i], refs[i] = download(fresh), np.full(sizes[i], -i - 1, dtype=np.int64)
        del fresh
    extra = torch.randint(-(2**62), 2**62, (1 << 21,), device=cuda)
    refs.append(extra.cpu().numpy().copy())
    held.append(download(extra))
    del extra
    assert len({a.ctypes.data for a in held}) == len(held)
    for got, want in zip(held, refs):
        assert _pinned(got) and np.array_equal(got, want)


@pytest.mark.cuda
def test_failed_pinned_allocation_falls_back_to_cpu(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory")
        return torch.zeros_like(*args, **kwargs)

    monkeypatch.setattr(torch, "empty_like", refuse)
    t = torch.arange(1 << 20, dtype=torch.int64, device=cuda)
    arr, totals = _counted(lambda: download(t))
    _same_array(arr, t.cpu().numpy())
    assert not _pinned(arr)
    assert totals == {"download_bytes": t.nbytes}


def _count(dev):
    return canonical_count_bytes(_bases(400_000, 1), CountConfig(K=31), device=dev)


def _stream(dev):
    sc = StreamingCounter(CountConfig(K=31, chunk_size=1 << 17), device=dev)
    sc.update(_bases(400_000, 2))
    return sc.finalize()


def _sharded(dev):
    mesh = par.data_mesh(1) if dev == "cuda" else par.data_mesh(1, device="cpu")
    return par.sharded_canonical_count(_bases(400_000, 3), par.ShardedCountConfig(K=31), mesh)


def _sketch(dev):
    return (minhash_sketch(_bases(400_000, 4), K=21, s=1000, device=dev),)


def _sixframe(dev):
    return sixframe_aa_count(_bases(400_000, 7), SixFrameCountConfig(K=7), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("entry, pinned", [(_count, True), (_stream, True), (_sharded, True), (_sixframe, True),
                                           (_sketch, False)])
def test_entries_download_large_tables_pinned_and_sketches_pageable(cuda, entry, pinned):
    """The count, stream and sharded tables (~400,000 rows, 3.2 MB each
    array) and the six-frame table (~800,000 rows) come back pinned, every
    downloaded byte through the pinned path; the sketch's 8 KB head does
    not.  Each equals the CPU device's answer."""
    got, totals = _counted(lambda: entry("cuda"))
    want = entry("cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_array(g, w)
        assert _pinned(g) == pinned
    share = totals.get("download_pinned_bytes", 0) / totals["download_bytes"]
    assert share == (1.0 if pinned else 0.0)
