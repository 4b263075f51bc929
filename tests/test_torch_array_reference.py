"""The JAX package's own array-plane tests, run against the port on the CPU.

Each of ``FILES`` is loaded by ``torch_reference.load``: read as text,
unedited, every import of ``kmers_tpu`` rewritten to ``kmers_tpu_torch``,
and run in a namespace of its own; its tests and fixtures are exposed here
under names prefixed with the file's stem.  A module-level import of a name
in ``DECLINED`` (ops the port leaves out by decision) is dropped, and every
test that uses such a name is left out.  An autouse fixture binds the CPU
for each test (``torch_reference.bind_cpu``): the port's ``device="cuda"``
defaults read ``"cpu"`` and its CLI gets ``--device cpu``, and both are put
back after, since one worker may run several files.

Left out (``LEFT_OUT``), each case with one of five reasons:

- ``DECLINED``: it uses an op the port declined (``u64``, ``window_u64``);
- ``PALLAS``: it sets the JAX configs' ``use_pallas=`` route switch, or
  calls a Pallas-only internal (``_extract``'s kernel branch,
  ``_use_pallas``); the port's device chooses the route;
- ``PRIVATE``: it calls or replaces a private helper with the JAX
  signature (``_smallest_prefix``, ``_chunk_count``, the
  ``(uh, ul, cnt, n_dev, cap, axis)`` exchange);
- ``JAX_RUNTIME``: it needs JAX devices or PRNG keys (``jax.random``
  keys, ``__graft_entry__`` over the JAX mesh);
- ``ARRAY_IN``: it hands a numpy or JAX array, in the JAX layout, to an op
  that takes a tensor.

Not loaded:

- ``test_ops.py`` and ``test_multiword.py``: they test the ops plane on the
  JAX layout (numpy in, ``(hi, lo)`` uint32 limbs out); the port's
  ``test_torch_*`` files hold each of those ops against the JAX op through
  ``convert.py``;
- ``test_pallas.py``: the Pallas kernels; the port's kernel tests hold
  each kernel's plain version against them in interpret mode;
- ``test_docs.py``: it runs ``docs/*.md``, which document ``kmers_tpu``;
  ``test_torch_docs.py`` runs the port's own pages against them;
- ``test_environment.py`` and ``test_multiproc.py``: JAX's own harness
  (``jax.distributed`` workers; F0 in ROADMAP.md).
"""

import ast
import inspect
import re

import pytest

from torch_reference import HERE, CUDA_DEFAULTS, bind_cpu, drop_declined, expose, load

FILES = (
    "test_tables.py",
    "test_io.py",
    "test_cli.py",
    "test_extras.py",
    "test_parallel.py",
    "test_checked_mode.py",
    "test_pipelines.py",
)

#: names of the JAX package the port leaves out by decision (ROADMAP.md)
DECLINED = (
    "u64", "stride", "pack_words", "PER_WORD", "window_u64",
    "window_valid_mask_om", "lookup_bytes",
)

DECLINED_OP = "DECLINED"
PALLAS = "PALLAS"
PRIVATE = "PRIVATE"
JAX_RUNTIME = "JAX_RUNTIME"
ARRAY_IN = "ARRAY_IN"

#: what each reason's case shows in its source
REASON_MARK = {
    DECLINED_OP: r"\b(" + "|".join(DECLINED) + r")\b",
    PALLAS: r"use_pallas|_use_pallas|_extract\(",
    PRIVATE: r"import _\w+|def poisoned\(uh, ul, cnt, n_dev, cap, axis\)",
    JAX_RUNTIME: r"jax\.random\.PRNGKey|__graft_entry__",
    ARRAY_IN: r"jnp\.asarray|classify_2bit\(np\.",
}

#: ``file::test``, ``file::Class`` or ``file::Class::test`` -> reason
LEFT_OUT = {
    "test_extras.py::TestRandom::test_device_multiword": JAX_RUNTIME,
    "test_extras.py::TestMinhash::test_two_stage_selection_exact": PRIVATE,
    "test_extras.py::TestUtils::test_pipeline_emits_metrics": PALLAS,
    "test_extras.py::TestBatchedRevtrans::test_parity": DECLINED_OP,
    "test_extras.py::TestDeviceRandom::test_device_sampling": JAX_RUNTIME,
    "test_extras.py::test_profile_step_reports_event_times": PRIVATE,
    "test_parallel.py::TestShardedCount::test_streamed_kernel_path_parity": PALLAS,
    "test_parallel.py::TestGraftEntry": JAX_RUNTIME,
    "test_parallel.py::TestSixFrame::test_split_pallas_path_parity": PALLAS,
    "test_parallel.py::TestSixFrame::test_fused_fe_parity": PALLAS,
    "test_parallel.py::TestSixFrame::test_fused_fe_multilimb_parity": PALLAS,
    "test_parallel.py::TestSixFrame::test_fused_fe_requires_pallas": PALLAS,
    "test_parallel.py::TestSixFrame::test_fused_fe_multichunk_stream": PALLAS,
    "test_parallel.py::TestShardedPallasPath": PALLAS,
    "test_checked_mode.py::TestArrayPlane::test_window_u64_short_stream_caught": DECLINED_OP,
    "test_checked_mode.py::TestArrayPlane::test_pipeline_conservation_clean": PALLAS,
    "test_checked_mode.py::TestArrayPlane::test_conservation_violation_detected": ARRAY_IN,
    "test_checked_mode.py::TestShardedPlane::test_sharded_violation_detected": PRIVATE,
    "test_pipelines.py::TestExtract::test_pallas_path_matches_jnp": PALLAS,
    "test_pipelines.py::TestExtract::test_use_pallas_gate_excludes_k32": PALLAS,
    "test_pipelines.py::TestStats::test_gc_vs_scalar": ARRAY_IN,
    "test_pipelines.py::test_streaming_level_stack_many_chunks_parity": PALLAS,
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with bind_cpu():
        yield


def _source(name: str, case: str) -> str:
    """The text of ``case`` (``test``, ``Class`` or ``Class::test``) in
    ``tests/<name>``, or None where it names nothing there."""
    src = (HERE / name).read_text()
    body = ast.parse(src).body
    node = None
    for part in case.split("::"):
        node = next((n for n in body if getattr(n, "name", None) == part), None)
        if node is None:
            return None
        body = node.body
    return ast.get_source_segment(src, node)


MODULES = {name: load(name, "torch_array_reference", DECLINED) for name in FILES}
# the source of each left-out case, read before ``expose`` removes it
LEFT_OUT_SOURCE = {key: _source(*key.split("::", 1)) for key in LEFT_OUT}
EXPOSED = {name: expose(name, mod, globals(), LEFT_OUT) for name, mod in MODULES.items()}


def test_left_out_names_only_cases_that_exist():
    missing = [key for key, src in LEFT_OUT_SOURCE.items() if src is None]
    assert not missing, missing
    assert all(EXPOSED.values()), EXPOSED


@pytest.mark.parametrize("key", sorted(LEFT_OUT))
def test_left_out_case_shows_its_reason(key):
    reason = LEFT_OUT[key]
    assert re.search(REASON_MARK[reason], LEFT_OUT_SOURCE[key]), (key, reason)


def test_declined_names_are_dropped_from_module_imports():
    tree = ast.parse(
        "from kmers_tpu_torch.ops import gc_count_u64, u64\n"
        "from kmers_tpu_torch.ops.windows import window_u64\n"
        "import numpy as np\n"
    )
    assert drop_declined(tree, DECLINED) == ["u64", "window_u64"]
    assert ast.unparse(tree) == (
        "from kmers_tpu_torch.ops import gc_count_u64\nimport numpy as np"
    )
    assert MODULES["test_pipelines.py"].__declined__ == ["u64"]
    assert all(not MODULES[n].__declined__ for n in FILES if n != "test_pipelines.py")


def test_cpu_binding_covers_the_entry_points_and_is_undone():
    import kmers_tpu_torch.__main__ as cli
    from kmers_tpu_torch.parallel import data_mesh
    from kmers_tpu_torch.pipelines import canonical_count_bytes, minhash_sketch
    from kmers_tpu_torch.pipelines.streaming import StreamingCounter
    from kmers_tpu_torch.random import rand_kmers_device

    bound = {fn for fn, _ in CUDA_DEFAULTS}
    fns = (canonical_count_bytes, minhash_sketch, StreamingCounter.__init__, data_mesh,
           rand_kmers_device)
    assert bound.issuperset(fns)
    # the sources keep their default; the autouse fixture bound the CPU
    assert all('device="cuda"' in inspect.getsource(fn) for fn in bound)
    assert all(inspect.signature(f).parameters["device"].default == "cpu" for f in fns)
    main, defaults = cli.main, [getattr(fn, attr) for fn, attr in CUDA_DEFAULTS]
    with bind_cpu():
        assert cli.main is not main
    assert cli.main is main
    assert [getattr(fn, attr) for fn, attr in CUDA_DEFAULTS] == defaults
