"""Nothing the benchmark runs loads JAX or the JAX package.

A fresh interpreter drives every cell at its CPU size (untraced, traced,
the four-rank cell over a local mesh, and a control) and then finds no
module whose top-level name is exactly ``jax``, ``jaxlib``, ``flax`` or
``kmers_tpu`` in ``sys.modules`` (``kmers_tpu_torch`` begins with
``kmers_tpu``, so names are compared whole).  A static scan finds no such
import in ``kmer_bench/``, and no import of the program in the
reference."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

from kmer_bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "kmers_tpu"}

DRIVE = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import SMALL, run_small
from kmers_tpu_torch.parallel.mesh import Mesh
for name in SMALL:
    kw = {{"mesh": Mesh(["cpu"] * 4)}} if name.endswith("_4gpu") else {{}}
    for trace in (False, True):
        _, line = run_small(name, seconds=0.2, trace=trace, **kw)
        assert line["correct"], (name, line)
    _, line = run_small(name, seconds=0.0, control=True, **kw)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_drive_of_every_cell_loads_no_jax():
    code = DRIVE.format(root=str(ROOT), tests=str(ROOT / "kmer_bench" / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "kmers_tpu_torch" in loaded and "kmer_bench" in loaded
    assert not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_and_the_reference_imports_no_program():
    sources = sorted((ROOT / "kmer_bench").rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        names = set(_imports(path))
        assert not names & FORBIDDEN, path
        if "reference" in path.parts:
            assert names <= {"__future__", "concurrent", "numpy", "os"}, path


def test_the_names_are_compared_whole():
    before = run.forbidden_modules()
    try:
        sys.modules["kmers_tpu_torch_fake"] = sys
        assert run.forbidden_modules() == before
        sys.modules["kmers_tpu.fake"] = sys
        assert "kmers_tpu" in run.forbidden_modules()
    finally:
        sys.modules.pop("kmers_tpu_torch_fake", None)
        sys.modules.pop("kmers_tpu.fake", None)
