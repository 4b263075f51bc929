"""The JAX package's own scalar-plane tests, run against the port.

Each of ``FILES`` is loaded by ``torch_reference.load``: read as text,
unedited, every import of ``kmers_tpu`` (the top level and its submodules,
module-level and function-local, in both ``import`` and ``from`` form)
rewritten to ``kmers_tpu_torch``, ``ast`` checks that no import of the JAX
package is left, and the result runs in a module namespace of its own.
Its tests are exposed here under names prefixed with the file's stem, so
names repeated across files do not clash.  The files define no fixtures of
their own; ``conftest.py``'s ``rng`` serves them all.

A few cases reach the array plane (``test_properties.py``'s
``TestPipelineProperties``, ``test_goldens.py``'s ``test_array_plane``),
whose entry points default to ``device="cuda"``; an autouse fixture binds
the CPU for each test (``torch_reference.bind_cpu``) and puts the defaults
back after.  No case is left out.
"""

import ast

import pytest

from torch_reference import bind_cpu, expose, imported_modules, load, port_source

FILES = (
    "test_kmer.py",
    "test_iterators.py",
    "test_transformations.py",
    "test_conformance.py",
    "test_api.py",
    "test_goldens.py",
    "test_properties.py",
    "test_seq.py",
    "test_revtrans.py",
)


@pytest.fixture(autouse=True)
def _on_cpu():
    with bind_cpu():
        yield


MODULES = {name: load(name, "torch_scalar_reference") for name in FILES}
EXPOSED = {name: expose(name, mod, globals()) for name, mod in MODULES.items()}


def test_rewrite_covers_every_import_form():
    src = (
        "import kmers_tpu as kt\n"
        "from kmers_tpu import (\n    Kmer,\n)\n"
        "from kmers_tpu.kmer import fx_hash\n"
        "def f():\n    from kmers_tpu.pipelines import canonical_count\n"
        "import kmers_tpu_torch\n"
    )
    mods = imported_modules(ast.parse(port_source(src)))
    assert mods == [
        "kmers_tpu_torch", "kmers_tpu_torch", "kmers_tpu_torch.kmer",
        "kmers_tpu_torch", "kmers_tpu_torch.pipelines",
    ]


def _origin(obj) -> str:
    return getattr(obj, "__module__", None) or getattr(obj, "__name__", "")


def test_every_file_runs_against_the_port():
    assert all(EXPOSED.values()), EXPOSED
    # every name a file imported at its top from a package of ours is the
    # port's (``test_goldens.py`` imports inside its tests only)
    ours = {
        (name, attr): _origin(obj)
        for name, mod in MODULES.items()
        for attr, obj in vars(mod).items()
        if _origin(obj).startswith("kmers_tpu")
    }
    assert {name for name, _ in ours} == set(FILES) - {"test_goldens.py"}
    assert all(m.startswith("kmers_tpu_torch") for m in ours.values()), ours
