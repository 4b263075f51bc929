"""The count-table algebra on the CPU: every function of
``kmers_tpu_torch.pipelines.tables`` against the JAX package's, on uint64
(K <= 31) and object (K > 31) tables, empty ones included; the device
merge (kernels K9 and K10 as their plain versions) against JAX's, also
where a sum passes 2^31; and the ``bench`` function."""

import importlib

import numpy as np
import pytest
import torch

from kmers_tpu.pipelines import tables as jt
from kmers_tpu_torch.pipelines import tables as tt

# (``pipelines`` exports a function of the module's name)
tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")


def _u64_table(rng, n, spread, top=9):
    keys = np.unique(rng.integers(0, spread, n)).astype(np.uint64)
    return keys, rng.integers(1, top, keys.size).astype(np.int64)


def _obj_table(rng, n, spread):
    keys, counts = _u64_table(rng, n, spread)
    # K > 31 registers: Python ints past 64 bits, in the same order
    return np.array([(1 << 70) + int(k) * 3 for k in keys], dtype=object), counts


def _tables(kind, rng):
    """Pairs of tables of one kind: overlapping, disjoint, one or both empty."""
    make = _u64_table if kind == "u64" else _obj_table
    a, b = make(rng, 300, 500), make(rng, 300, 500)
    far = make(rng, 50, 100)
    far = (far[0] + (np.uint64(1000) if kind == "u64" else 3000), far[1])
    empty = (np.zeros(0, np.uint64 if kind == "u64" else object), np.zeros(0, np.int64))
    return [(a, b), (a, far), (a, empty), (empty, b), (empty, empty), (a, a)]


def _same(got, want):
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert got[0].tolist() == want[0].tolist() and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["u64", "obj"])
def test_table_functions_match_jax(rng, kind):
    for a, b in _tables(kind, rng):
        _same(tt.merge_counts(*a, *b), jt.merge_counts(*a, *b))
        for mode in ("min", "sum"):
            _same(tt.intersect_counts(*a, *b, mode=mode), jt.intersect_counts(*a, *b, mode=mode))
        _same(tt.subtract_counts(*a, *b), jt.subtract_counts(*a, *b))
        _same(tt.subtract_counts(*b, *a), jt.subtract_counts(*b, *a))
        assert tt.jaccard_exact(a[0], b[0]) == jt.jaccard_exact(a[0], b[0])
        assert tt.containment(a[0], b[0]) == jt.containment(a[0], b[0])
        assert tt.containment(b[0], a[0]) == jt.containment(b[0], a[0])


def test_merge_counts_sums_and_sorts(rng):
    a, b = _u64_table(rng, 400, 600), _u64_table(rng, 400, 600)
    keys, counts = tt.merge_counts(*a, *b)
    want = {}
    for k, c in [*zip(a[0].tolist(), a[1].tolist()), *zip(b[0].tolist(), b[1].tolist())]:
        want[k] = want.get(k, 0) + c
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    assert np.all(keys[1:] > keys[:-1]) and keys.dtype == np.uint64


def test_intersect_mode_and_shape_errors_match_jax(rng):
    a, b = _u64_table(rng, 10, 20), _u64_table(rng, 10, 20)
    for fn in (tt.intersect_counts, jt.intersect_counts):
        with pytest.raises(ValueError, match="mode"):
            fn(*a, *b, mode="max")
    for fn in (tt.merge_counts, jt.merge_counts):
        with pytest.raises(ValueError, match="equal-length"):
            fn(a[0], a[1][:-1], *b)


@pytest.mark.parametrize("clamp", [None, 4, 8])
def test_multiplicity_spectrum_matches_jax(rng, clamp):
    for counts in (np.array([1, 1, 2, 5, 5, 5, 9], np.int64), rng.integers(1, 30, 500), np.zeros(0, np.int64)):
        got = tt.multiplicity_spectrum(counts, max_multiplicity=clamp)
        want = jt.multiplicity_spectrum(counts, max_multiplicity=clamp)
        assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("case", ["overlap", "disjoint", "a empty", "both empty", "same", "wide keys"])
def test_merge_counts_device_matches_jax(rng, case):
    a, b = _u64_table(rng, 3000, 5000), _u64_table(rng, 2000, 5000)
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.int64))
    wide = _u64_table(rng, 1000, 1 << 62)
    a, b = {
        "overlap": (a, b),
        "disjoint": (a, (b[0] + np.uint64(10_000), b[1])),
        "a empty": (empty, b),
        "both empty": (empty, empty),
        "same": (a, a),
        "wide keys": (wide, a),
    }[case]
    got = tt.merge_counts_device(*a, *b, device="cpu")
    _same(got, jt.merge_counts_device(*a, *b))
    _same(got, tt.merge_counts(*a, *b))


def test_merge_counts_device_sums_past_2_31_on_the_device():
    # the JAX device merge counts in int32 and takes the host merge here;
    # the port's device merge counts in int64 and gives the same table
    k = np.array([5, 9], np.uint64)
    big = np.array([2**30 + 7, 3], np.int64)
    got = tt.merge_counts_device(k, big, k, big, device="cpu")
    _same(got, jt.merge_counts_device(k, big, k, big))
    assert got[1].tolist() == [2**31 + 14, 6]
    huge = np.array([2**40, 2**33], np.int64)
    assert tt.merge_counts_device(k, huge, k, big, device="cpu")[1].tolist() == [2**40 + 2**30 + 7, 2**33 + 3]


def test_merge_counts_device_takes_k31_tables_only():
    k = np.array([1 << 62], np.uint64)
    with pytest.raises(ValueError, match="K <= 31"):
        tt.merge_counts_device(k, np.ones(1, np.int64), k, np.ones(1, np.int64), device="cpu")


def test_bench_returns_the_headline_line():
    line = tcc.bench(L=1 << 14, device="cpu")
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "canonical_31mer_count_bases_per_sec_per_chip"
    assert line["unit"] == "bases/sec" and isinstance(line["value"], int) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 5.0e7, 3)


def test_bench_counts_the_reference_chunk():
    # the JAX CLI's draw, and its _chunk_count's distinct count on it
    jcc = importlib.import_module("kmers_tpu.pipelines.canonical_count")
    L = 1 << 14
    data = np.frombuffer(b"ACGT", dtype=np.uint8)[np.random.default_rng(0).integers(0, 4, L)]
    assert np.array_equal(tcc.bench_input(L), data)
    _, scalars = tcc._count_chunk(torch.from_numpy(tcc.bench_input(L)), 31, False)
    want = jcc._chunk_count(data, 31, False)
    assert scalars.tolist() == [int(want[3]), int(want[4]), int(want[5])]
