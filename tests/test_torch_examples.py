"""The port's four examples (``examples/torch_port/*.py``) against the JAX
package's (``examples/*.py``), on the CPU.

Each example runs in process (``runpy.run_path`` with a patched
``sys.argv``), the port's with ``--device cpu`` added to the JAX
example's arguments, on small FASTA and FASTQ files: a few kb in several
records, with N runs, IUPAC codes, soft-masked (lower-case) stretches and
repeats.  The port's standard output must equal the JAX example's.
``count_fasta.py`` writes its metrics (with wall times) to stderr, and
``stream_count.py`` its batch lines; stderr is not compared.  The JAX
``minimizer_index.py`` compiles once for each clean segment's length, so
it runs on two records.
"""

import gzip
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = ROOT / "examples" / "torch_port"
EXAMPLES = ("count_fasta.py", "stream_count.py", "minimizer_index.py", "sketch_compare.py")


def _records(seed: int, n: int = 6) -> list:
    """``n`` records of 300-900 bases: uniform ACGT with an N run, a few
    IUPAC codes, a soft-masked stretch and a repeated motif, so that the
    top counts exceed 1."""
    rng = np.random.default_rng(seed)
    motif = "".join("ACGT"[i] for i in rng.integers(0, 4, 40))
    out = []
    for _ in range(n):
        s = list("".join("ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(300, 900)))))
        at = int(rng.integers(0, len(s) - 30))
        s[at : at + int(rng.integers(1, 25))] = "N" * len(s[at : at + 24])
        for i in rng.integers(0, len(s), 3):
            s[i] = "RYKMSWBDHV"[int(rng.integers(0, 10))]
        lo = int(rng.integers(0, len(s) - 60))
        s[lo : lo + 50] = [c.lower() for c in s[lo : lo + 50]]
        out.append(motif * int(rng.integers(1, 4)) + "".join(s))
    return out


def _fasta(path: Path, records) -> Path:
    path.write_text("".join(f">r{i} test record\n{r[:70]}\n{r[70:]}\n" for i, r in enumerate(records)))
    return path


def _fastq_gz(path: Path, records) -> Path:
    path.write_bytes(gzip.compress(
        "".join(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(records)).encode()))
    return path


def _mutated(records, seed: int, rate: float = 0.01) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for r in records:
        s = list(r)
        for i in np.flatnonzero(rng.random(len(s)) < rate):
            s[i] = "ACGT"[("ACGT".find(s[i].upper()) + 1) % 4]
        out.append("".join(s))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    recs = _records(1)
    return {
        "fasta": _fasta(d / "genome.fa", recs),
        "fastq": _fastq_gz(d / "reads.fq.gz", recs),
        "mutated": _fasta(d / "mutated.fa", _mutated(recs, 2)),
        "other": _fasta(d / "other.fa", _records(3)),
        # two records: the JAX example compiles once a clean segment length
        "short": _fasta(d / "short.fa", _records(4, n=2)),
    }


def run_example(path: Path, argv, capsys) -> str:
    """Run the script at ``path`` as ``__main__`` with ``argv``; its stdout."""
    capsys.readouterr()
    saved = sys.argv
    sys.argv = [str(path), *map(str, argv)]
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved
    return capsys.readouterr().out


CASES = [
    ("count_fasta.py", ["{fasta}", "-k", "31"]),
    ("count_fasta.py", ["{fastq}", "-k", "15", "--top", "5"]),
    ("stream_count.py", ["{fastq}"]),
    ("stream_count.py", ["{fasta}", "31"]),
    ("minimizer_index.py", ["{short}", "-k", "15", "-w", "10"]),
    ("sketch_compare.py", ["{fasta}", "{mutated}", "{other}"]),
    ("sketch_compare.py", ["{fastq}", "{other}", "-k", "21", "-s", "200"]),
]


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_port_example_prints_what_the_jax_example_prints(name, args, inputs, capsys):
    argv = [a.format(**inputs) for a in args]
    want = run_example(JAX_EXAMPLES / name, argv, capsys)
    got = run_example(PORT_EXAMPLES / name, [*argv, "--device", "cpu"], capsys)
    assert want.strip(), name
    assert got == want


def test_every_example_has_a_port():
    assert sorted(p.name for p in JAX_EXAMPLES.glob("*.py")) == sorted(EXAMPLES)
    assert sorted(p.name for p in PORT_EXAMPLES.glob("*.py")) == sorted(EXAMPLES)
    assert {name for name, _ in CASES} == set(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_defaults_to_the_card(name):
    src = (PORT_EXAMPLES / name).read_text()
    assert 'p.add_argument("--device", default="cuda"' in src
    assert "device=args.device" in src
