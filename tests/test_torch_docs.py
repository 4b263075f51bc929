"""Every ```python block of ``docs/torch_port/*.md``, on the CPU, against
the JAX package's page.

The port's pages are the counterparts of ``docs/*.md``, one for each
(``gpu.md`` in place of ``tpu.md``), with the same blocks in the same
order and the JAX page's variable names.  Each port page runs with
:func:`docs_namespace` (the free variables of
``tests/test_docs.py``'s preamble, with ``device="cpu"``); each JAX page
with ``tests/test_docs.py``'s own preamble, on the same ``seq`` and the same
FASTQ file.  After each block every variable that both blocks bound is
held equal, bit for bit: numpy arrays by value (the JAX package counts in
``int32`` where the port counts in ``int64``), tensors against JAX arrays
by value, registers and hashes through ``convert.py`` where the layouts
differ (``CONVERTED``), k-mers by alphabet, K and value.

The port's entry points default to ``device="cuda"``, so a block that
forgot ``device=device`` raises here, where there is no GPU.  On a card,
the test marked ``cuda`` runs each port page with ``device="cuda"`` and
holds its values against the same page on the CPU (run it with
``python -m pytest tests/test_torch_docs.py -m cuda --noconftest -o addopts="" -q``).

The value of each top-level expression statement (what an interactive
session shows) is held equal too, in order.  Not compared
(``NOT_COMPARED``, ``EXPR_NOT_COMPARED``), each with its reason; a block
that binds a name that is neither compared nor listed fails the test.
"""

import ast
import re
import shutil
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_DOCS = ROOT / "docs"
DOCS_PORT = ROOT / "docs" / "torch_port"

def doc_pages() -> list:
    """``(name, blocks)`` for each page of ``docs/torch_port`` that holds
    ```python blocks, in name order."""
    out = []
    for p in sorted(DOCS_PORT.glob("*.md")):
        blocks = re.findall(r"```python\n(.*?)```", p.read_text(), re.S)
        if blocks:
            out.append((p.name, blocks))
    return out


def docs_namespace(seq: str, fastx_path: str, tmp_path: Path, device) -> dict:
    """The free variables of the port's pages, as ``tests/test_docs.py``'s
    preamble binds them for the JAX pages: a DNA string ``seq`` (and
    ``seq_a``, ``seq_b``), its 2-bit ``codes`` on ``device``, the window
    parameters ``K`` and ``W``, a 4-bit ``Seq``, a checkpoint's ``rank`` and
    ``n``, a few names of the top level, ``tmp_path``, a gzip FASTQ file
    ``fastx_path`` and ``device``."""
    import torch

    import kmers_tpu_torch as kt
    from kmers_tpu_torch.ops.encode import classify_2bit

    data = torch.frombuffer(bytearray(seq.encode()), dtype=torch.uint8).to(device)
    return {
        "np": np,
        "seq": seq,
        "seq_a": seq,
        "seq_b": seq[1:] + "A",
        "codes": classify_2bit(data)[0],
        "K": 15,
        "W": 10,
        "seq4bit": kt.Seq(kt.DNAAlphabet4(), "TGCA"),
        "rank": 0,
        "n": 1,
        "fx_hash": kt.fx_hash,
        "CanonicalDNAMers": kt.CanonicalDNAMers,
        "AAKmer": kt.AAKmer,
        "DNAAlphabet2": kt.DNAAlphabet2,
        "DNAAlphabet4": kt.DNAAlphabet4,
        "AminoAcidAlphabet": kt.AminoAcidAlphabet,
        "ncbi_trans_table": kt.ncbi_trans_table,
        "tmp_path": tmp_path,
        "fastx_path": fastx_path,
        "device": device,
    }


def run_doc_blocks(page: str, blocks, ns: dict) -> list:
    """Run ``blocks`` one after another in ``ns`` (one page's blocks share a
    namespace); for each block, the names it bound or rebound and their
    values.  A block that raises ends the run."""
    bound = []
    for i, block in enumerate(blocks):
        before = dict(ns)
        try:
            exec(compile(block, f"{page}[block {i}]", "exec"), ns)
        except Exception as e:
            raise AssertionError(f"{page} block {i}: {e!r}\n{block}") from e
        bound.append({k: v for k, v in ns.items() if k not in before or before[k] is not v})
    return bound


#: port variable -> (the JAX page's variables, how to bring them to the port's layout)
CONVERTED = {
    ("replacements.md", "regs"): (("hi", "lo"), lambda hi, lo: _keys(hi, lo)),
    ("replacements.md", "h"): (("hh", "hl"), lambda hh, hl: _hashes(hh, hl)),
    ("replacements.md", "m"): (("mh", "ml"), lambda mh, ml: _hashes(mh, ml)),
    ("translation.md", "kmers6"): (("kmers6",), lambda k6: [_keys(*hl) for hl in k6]),
}

#: (page, variable) -> why it is not compared
NOT_COMPARED = {
    ("composition.md", "sc"): "a StreamingCounter; its table (kmers, counts) is compared",
    ("composition.md", "m"): "a Metrics collector holding wall seconds; its counts are compared below",
    ("debugging.md", "top"): "profiler event names: torch.profiler's kernels, not jax.profiler's",
    ("minhash.md", "sk"): "a StreamingSketcher; its sketch is compared",
    ("random.md", "gen"): "a torch.Generator; the JAX page binds no key",
    ("random.md", "regs"): "rand_kmers_device's draw: the JAX page has no block for it, and "
                           "jax.random and torch.Generator streams differ",
    ("random.md", "words"): "as regs",
}


#: (page, block, n-th top-level expression) -> why its value is not compared
EXPR_NOT_COMPARED = {
    ("random.md", 0, 2): "rand_symbol without rng= draws from a fresh generator",
}

#: how many values each page's comparison reaches: bound variables, then
#: the values of top-level expressions
COMPARED = {
    "composition.md": (26, 2), "debugging.md": (1, 0), "iteration.md": (4, 0), "kmers.md": (0, 4),
    "minhash.md": (10, 2), "random.md": (0, 5), "replacements.md": (5, 0), "translation.md": (3, 5),
}


def _keys(hi, lo):
    from kmers_tpu_torch.convert import keys_from_jax

    return keys_from_jax(np.asarray(hi), np.asarray(lo))


def _hashes(hh, hl):
    from kmers_tpu_torch.convert import hashes_from_jax

    return hashes_from_jax(np.asarray(hh), np.asarray(hl))


def _is_value(v) -> bool:
    """Not an imported module, class or function."""
    return not isinstance(v, (types.ModuleType, type)) and not callable(v)


def _norm(x):
    """``x`` in a form both packages share: arrays and tensors as numpy,
    k-mers and codon sets by their identity, containers element by
    element."""
    import torch

    if isinstance(x, torch.Tensor):
        return np.asarray(x.cpu().numpy())
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    if isinstance(x, np.generic):
        return x.item()
    if hasattr(x, "alphabet") and hasattr(x, "value") and hasattr(x, "K"):  # a Kmer
        return ("kmer", type(x.alphabet).__name__, x.K, int(x.value))
    if type(x).__name__ == "CodonSet":
        return ("codons", int(x.x))
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, dict):
        return {_norm(k): _norm(v) for k, v in x.items()}
    return x


def same(a, b) -> bool:
    a, b = _norm(a), _norm(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return a.shape == b.shape and [int(x) for x in a.ravel()] == [int(x) for x in b.ravel()]
        return a.shape == b.shape and np.array_equal(a.astype(object), b.astype(object))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _pages():
    jax_pages = {p.name for p in JAX_DOCS.glob("*.md")}
    return [(name, blocks) for name, blocks in doc_pages() if name in jax_pages]


def _jax_blocks(name):
    return re.findall(r"```python\n(.*?)```", (JAX_DOCS / name).read_text(), re.S)


def with_outputs(block: str, i: int) -> str:
    """``block`` with each top-level expression statement's value kept in
    ``__out__[i]``, in order (an interactive session shows them)."""
    tree = ast.parse(block)
    for node in tree.body:
        if isinstance(node, ast.Expr):
            call = ast.parse(f"__out__.setdefault({i}, []).append(0)").body[0].value
            call.args = [node.value]
            node.value = call
    return ast.unparse(ast.fix_missing_locations(tree))


def _run_both(name, blocks, tmp_path, monkeypatch):
    import test_docs

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_ns = test_docs._preamble(jax_dir)
    fastx = port_dir / Path(jax_ns["fastx_path"]).name
    shutil.copy(jax_ns["fastx_path"], fastx)
    port_ns = docs_namespace(jax_ns["seq"], str(fastx), port_dir, "cpu")
    jax_ns["__out__"], port_ns["__out__"] = {}, {}
    monkeypatch.chdir(jax_dir)  # the pages write and read relative paths
    jax_bound = run_doc_blocks(name, [with_outputs(b, i) for i, b in enumerate(_jax_blocks(name))], jax_ns)
    monkeypatch.chdir(port_dir)
    port_bound = run_doc_blocks(name, [with_outputs(b, i) for i, b in enumerate(blocks)], port_ns)
    return (jax_bound, jax_ns["__out__"]), (port_bound, port_ns["__out__"])


@pytest.mark.parametrize("name,blocks", _pages(), ids=[n for n, _ in _pages()])
def test_port_page_matches_the_jax_page(name, blocks, tmp_path, monkeypatch):
    (jax_bound, jax_out), (port_bound, port_out) = _run_both(name, blocks, tmp_path, monkeypatch)
    assert len(port_bound) == len(jax_bound), "the port's page has the JAX page's blocks"
    compared = 0
    for i, (port, jax) in enumerate(zip(port_bound, jax_bound)):
        for var, value in port.items():
            if var in ("__builtins__", "__out__") or not _is_value(value):
                continue
            if (name, var) in NOT_COMPARED:
                continue
            if (name, var) in CONVERTED:
                names, convert = CONVERTED[(name, var)]
                want = convert(*(jax[n] for n in names))
            else:
                assert var in jax, f"{name} block {i}: {var} is bound by the port's page only"
                want = jax[var]
            assert same(value, want), f"{name} block {i}: {var} differs"
            compared += 1
        if name == "composition.md" and "m" in port:
            drop = ("seconds", "bases_per_sec")
            assert {k: v for k, v in port["m"].summary().items() if k not in drop} == {
                k: v for k, v in jax["m"].summary().items() if k not in drop}
    shown = 0
    for i in range(len(blocks)):
        port, jax = port_out.get(i, []), jax_out.get(i, [])
        assert len(port) == len(jax), f"{name} block {i}: the JAX block's expressions"
        for j, (a, b) in enumerate(zip(port, jax)):
            if (name, i, j) not in EXPR_NOT_COMPARED:
                assert same(a, b), f"{name} block {i}: expression {j} differs: {a!r} vs {b!r}"
                shown += 1
    assert (compared, shown) == COMPARED[name]


def _port_inputs(tmp_path):
    """``seq`` and ``fastx_path`` as ``tests/test_docs.py``'s preamble draws
    them (600 bases, then six reads of 200 from the same generator), with
    no import of the JAX package."""
    import test_docs

    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 600))
    return seq, test_docs._write_fastx_gz(tmp_path, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("name,blocks", doc_pages(), ids=[n for n, _ in doc_pages()])
def test_port_page_runs_on_the_card(name, blocks, tmp_path, monkeypatch):
    """Each port page with ``device="cuda"``: every block runs, and every
    value it binds or shows equals the same page's on the CPU."""
    import torch

    # decided here, never at import: every xdist worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = []
    for device in ("cpu", "cuda"):
        where = tmp_path / device
        where.mkdir()
        ns = docs_namespace(*_port_inputs(where), where, device)
        ns["__out__"] = {}
        monkeypatch.chdir(where)  # the pages write and read relative paths
        runs.append((run_doc_blocks(name, [with_outputs(b, i) for i, b in enumerate(blocks)], ns), ns["__out__"]))
    (cpu_bound, cpu_out), (card_bound, card_out) = runs
    for i, (card, cpu) in enumerate(zip(card_bound, cpu_bound)):
        for var, value in card.items():
            if var in ("__builtins__", "__out__") or not _is_value(value) or (name, var) in NOT_COMPARED:
                continue
            assert same(value, cpu[var]), f"{name} block {i}: {var} differs on the card"
    for i in range(len(blocks)):
        card, cpu = card_out.get(i, []), cpu_out.get(i, [])
        assert len(card) == len(cpu)
        for j, (a, b) in enumerate(zip(card, cpu)):
            if (name, i, j) not in EXPR_NOT_COMPARED:
                assert same(a, b), f"{name} block {i}: expression {j} differs on the card: {a!r} vs {b!r}"


def test_every_jax_page_has_a_port_page():
    port = {p.name for p in DOCS_PORT.glob("*.md")}
    jax = {p.name for p in JAX_DOCS.glob("*.md")}
    assert port == (jax - {"tpu.md"}) | {"gpu.md"}
    for name in port & jax:
        assert len(_jax_blocks(name)) == len(dict(doc_pages()).get(name, ())), name


def test_the_pages_run_with_the_ports_cuda_defaults():
    # so a call without ``device=device`` raises on this CPU-only host
    import inspect

    from kmers_tpu_torch.pipelines import canonical_count, extract_kmers, minhash_sketch

    for fn in (canonical_count, extract_kmers, minhash_sketch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert {name for name, _ in doc_pages()} == {name for name, _ in _pages()}


def test_not_compared_names_are_bound_by_their_page():
    for (page, var), why in NOT_COMPARED.items():
        src = "\n".join(dict(doc_pages())[page])
        assert re.search(rf"^{var}\b\s*(,[^=\n]*)?=", src, re.M), (page, var)
        assert why
