"""The JAX package's own scalar-plane tests, run against the port.

Each of ``FILES`` is read as text, unedited: every import of ``kmers_tpu``
(the top level and its submodules, module-level and function-local, in
both ``import`` and ``from`` form) is rewritten to ``kmers_tpu_torch``,
``ast`` checks that no import of the JAX package is left, and the result
runs in a module namespace of its own.  Its tests are exposed here under
names prefixed with the file's stem, so names repeated across files do
not clash.  The files define no fixtures of their own; ``conftest.py``'s
``rng`` serves them all.

Left out (``LEFT_OUT``): the cases that reach the array plane, whose port
defaults to ``device="cuda"``; the port's ``test_torch_canonical_count.py``
and ``test_torch_extract.py`` hold those paths against the JAX package on
the CPU:

- ``test_properties.py::TestPipelineProperties::test_counting_oracle``
- ``test_properties.py::TestPipelineProperties::test_minimizer_skip_oracle``
- ``test_goldens.py::TestGoldens::test_array_plane`` (4 cases)
"""

import ast
import re
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent

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

#: file -> {class: methods left out, or None for the whole class}
LEFT_OUT = {
    "test_properties.py": {"TestPipelineProperties": None},
    "test_goldens.py": {"TestGoldens": ("test_array_plane",)},
}

# ``import kmers_tpu...`` / ``from kmers_tpu... import``, at any indentation
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)kmers_tpu\b(?!_torch)", re.M)


def port_source(src: str) -> str:
    """``src`` with every import of the JAX package pointed at the port."""
    return _IMPORT.sub(r"\1kmers_tpu_torch", src)


def imported_modules(tree: ast.AST) -> list:
    """The module names that ``tree``'s import statements name."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append(node.module)
    return out


def load(name: str) -> types.ModuleType:
    """Run the rewritten ``tests/<name>`` in a fresh module namespace."""
    path = HERE / name
    src = port_source(path.read_text())
    tree = ast.parse(src, filename=str(path))
    left = [m for m in imported_modules(tree) if m.split(".")[0] == "kmers_tpu"]
    assert not left, f"{name} still imports {left}"
    mod = types.ModuleType(f"torch_scalar_reference.{path.stem}")
    mod.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def _expose(name: str, mod: types.ModuleType) -> int:
    """Copy the tests of ``mod``, loaded from ``name``, into this module's
    globals; returns how many test functions and classes it exposed."""
    tag = Path(name).stem[len("test_"):]
    skip = LEFT_OUT.get(name, {})
    n = 0
    for attr, obj in vars(mod).items():
        if attr.startswith("test_") and callable(obj):
            globals()[f"test_{tag}__{attr[len('test_'):]}"] = obj
            n += 1
        elif attr.startswith("Test") and isinstance(obj, type):
            if attr in skip and skip[attr] is None:
                continue
            for method in skip.get(attr, ()):
                delattr(obj, method)  # the class is this namespace's own
            globals()[f"Test_{tag}__{attr[len('Test'):]}"] = obj
            n += 1
    return n


MODULES = {name: load(name) for name in FILES}
EXPOSED = {name: _expose(name, mod) for name, mod in MODULES.items()}


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
