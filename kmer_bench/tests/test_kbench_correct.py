"""What decides ``correct``, on the CPU at each cell's small size: a sound
run reads every number at 0; the control (the reference with one
guarantee broken, in the program's place) and each fault a cell can have,
planted in the program under a run, read ``correct`` false.

Faults: a step that returns its state unchanged (the first answer
returned again, or a batch that never reaches the counter), half of the
input left out, an answer altered where it is produced (a count or a hash
off by one), and, on four ranks, the exchange between them left out."""

import importlib

import numpy as np
import pytest
import torch

from conftest import SMALL, run_small

from kmers_tpu_torch.parallel.mesh import Mesh

# the modules themselves: ``pipelines`` exports functions of the same names
cc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
mh = importlib.import_module("kmers_tpu_torch.pipelines.minhash")
st = importlib.import_module("kmers_tpu_torch.pipelines.streaming")
pp = importlib.import_module("kmers_tpu_torch.parallel.pipeline")

CELLS = list(SMALL)


def _kwargs(name):
    return {"mesh": Mesh(["cpu"] * 4)} if name.endswith("_4gpu") else {}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    _, line = run_small(name, **_kwargs(name))
    assert line["correct"] and line["attempted"] > 0
    assert all(c["value"] == 0 == c["limit"] for c in line["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    _, line = run_small(name, seconds=0.0, control=True, **_kwargs(name))
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["check"].values())


def _stale(fn):
    """The first result, returned again for every later call."""
    first = []

    def stale(*a, **kw):
        if not first:
            first.append(fn(*a, **kw))
        return first[0]

    return stale


def _half_bytes(fn):
    def half(data, *a, **kw):
        arr = np.asarray(data)
        return fn(arr[: arr.size // 2], *a, **kw)

    return half


def _count_off_by_one(fn):
    def bump(*a, **kw):
        uniq, counts, n = fn(*a, **kw)
        real = torch.nonzero(counts)
        if real.numel():
            counts = counts.clone()
            counts[real[0]] += 1
        return uniq, counts, n

    return bump


def _hash_off_by_one(fn):
    def bump(*a, **kw):
        head, boundary = fn(*a, **kw)
        head = head.copy()
        head[0] += 1
        return head, boundary

    return bump


def _table_off_by_one(fn):
    """The finished table with its first count off by one (after the
    counter's own check of the windows it counted)."""

    def bump(*a, **kw):
        kmers, counts = fn(*a, **kw)
        counts = counts.copy()
        counts[0] += 1
        return kmers, counts

    return bump


def _half_records(fn):
    def half(self, seq, offsets=None):
        mid = (offsets.size - 1) // 2
        return fn(self, seq[: offsets[mid]], offsets[: mid + 1])

    return half


def _no_exchange(tables, mesh, cap):
    return [(k, c, (c > 0).sum()) for k, c in tables], 0


FAULTS = {
    "jellyfish_k31.chr21": [
        ("state unchanged", cc, "count_stream", _stale),
        ("half the input", cc, "_upload", lambda fn: lambda data, *a: fn(np.asarray(data)[: len(data) // 2], *a)),
        ("answer altered", cc, "sort_count", _count_off_by_one),
    ],
    "mash_k21_s1000.bacteria": [
        ("state unchanged", mh, "_sketch_keys", _stale),
        ("half the input", mh, "as_byte_array", lambda fn: lambda data: fn(data)[: len(data) // 2]),
        ("answer altered", mh, "_smallest", _hash_off_by_one),
    ],
    "jellyfish_k31.reads30x": [
        ("state unchanged", st.StreamingCounter, "update", lambda fn: lambda self, *a, **kw: None),
        ("half the input", st.StreamingCounter, "update", _half_records),
        ("answer altered", st.StreamingCounter, "finalize", _table_off_by_one),
    ],
    "jellyfish_k31.chr21_4gpu": [
        ("state unchanged", pp, "count_stream", _stale),
        ("half the input", pp, "as_byte_array", _half_bytes),
        ("answer altered", cc, "sort_count", _count_off_by_one),
        ("exchange left out", pp, "exchange_and_merge", lambda fn: _no_exchange),
    ],
}
CASES = [(name, *fault) for name, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("name,fault,target,attr,plant", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault, target, attr, plant):
    monkeypatch.setattr(target, attr, plant(getattr(target, attr)))
    _, line = run_small(name, seconds=0.3, **_kwargs(name))
    assert not line["correct"], fault
