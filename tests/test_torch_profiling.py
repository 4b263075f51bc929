"""The port's profiling hooks (``kmers_tpu_torch/utils/profiling.py``) on the
CPU: ``profile_step`` as ``tests/test_extras.py::test_profile_step_reports_event_times``
holds the reference's, and ``trace``, ``annotate`` and ``device_op_times``
around a counting step."""

import json

import numpy as np
import torch

from kmers_tpu_torch.pipelines.canonical_count import _count_chunk
from kmers_tpu_torch.utils import annotate, device_op_times, profile_step, trace

DATA = torch.from_numpy(np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(0).integers(0, 4, 1 << 12)].copy())


def _step():
    out = _count_chunk(DATA, 15, False)
    out[1].tolist()


def test_profile_step_reports_event_times():
    top = profile_step(_step, reps=1, top=5)
    assert top, "no trace events captured"
    assert len(top) <= 5
    assert all(isinstance(n, str) and ms >= 0 for n, ms in top)
    # ordered by total duration
    assert [ms for _, ms in top] == sorted((ms for _, ms in top), reverse=True)


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("count one chunk"):
            _step()
    (path,) = tmp_path.glob("*.pt.trace.json")
    assert json.loads(path.read_text())["traceEvents"]
    times = device_op_times(str(tmp_path))
    assert times["count one chunk"] > 0
    # the range holds the step's operators
    assert any(name.startswith("aten::") for name in times)
    assert any(e.name == "count one chunk" for e in prof.events())


def test_trace_without_a_directory_writes_nothing(tmp_path):
    with trace(None) as prof:
        _step()
    assert prof.events() and not list(tmp_path.iterdir())
    assert device_op_times(str(tmp_path)) == {}
