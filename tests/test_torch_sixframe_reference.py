"""``sixframe_aa_count`` held against the plain six-frame reference
(``reference/sixframe_aa.py``, plain torch, nothing of either package) on
the CPU: keys and counts exactly, at K = 1, 3 and 7 (K4's range) and 8 and
12 (K5's), with chunks small enough that the fold merges a dozen times.
The reference itself against a brute-force translation in Python, its
block size, its changed-base delta and seam control, and the benchmark's
frozen copy of it."""

import ast
import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kmers_tpu_torch import SixFrameCountConfig, sixframe_aa_count
from kmers_tpu_torch.genetic_codes import AA_CHARS, standard_genetic_code

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from reference import sixframe_aa as ref  # noqa: E402

#: 200 kb in chunks of 2^14 bases: 13 chunks, so the fold merges 12 times
CHUNK = 1 << 14
#: NCBI's own listing of translation table 1, codons in T, C, A, G order
NCBI_TABLE_1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes torch's thread team only
    contends with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genome(seed: int, n: int = 200_000) -> np.ndarray:
    """Uniform ACGT with soft-masked runs, N blocks, IUPAC codes, a U, a
    poly-A run and a repeated stretch (so some rows count more than once)."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    r = n // 100
    seq[75 * r : 76 * r] = seq[5 * r : 6 * r]
    seq[30 * r : 31 * r] = ord("A")
    for a in rng.integers(0, 98 * r, 6):
        seq[a : a + rng.integers(r // 2, 2 * r)] |= 0x20
    for a in rng.integers(0, 99 * r, 4):
        seq[a : a + rng.integers(1, r)] = ord("N")
    seq[rng.integers(0, n, 12)] = np.frombuffer(b"RYKMSWryn", np.uint8)[rng.integers(0, 9, 12)]
    seq[n // 2] = ord("U")
    return seq


def brute_table(seq: bytes, k: int) -> collections.Counter:
    """Every frame of both strands translated codon by codon from NCBI's
    listing, each window of k codons over certain bases keyed by its amino
    acids' codes, 8 bits each, the first highest."""
    up = seq.upper().replace(b"U", b"T")
    strands = (up, up.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1])
    table = collections.Counter()
    for s in strands:
        for f in range(3):
            codons = [s[i : i + 3] for i in range(f, len(s) - 2, 3)]
            for j in range(len(codons) - k + 1):
                window = codons[j : j + k]
                if any(b not in b"ACGT" for c in window for b in c):
                    continue
                key = 0
                for c in window:
                    idx = 16 * "TCAG".index(chr(c[0])) + 4 * "TCAG".index(chr(c[1])) + "TCAG".index(chr(c[2]))
                    key = (key << 8) | AA_CHARS.index(NCBI_TABLE_1[idx])
                table[key] += 1
    return table


@pytest.mark.parametrize("K", [1, 3, 7, 8, 12])
def test_the_port_matches_the_reference(K):
    seq = _genome(K)
    kmers, counts = sixframe_aa_count(seq, SixFrameCountConfig(K=K, chunk_size=CHUNK), device="cpu")
    want_k, want_c = ref.count_table(seq, K)
    assert kmers.dtype == want_k.dtype == (np.uint64 if K <= 7 else object)
    assert list(kmers) == list(want_k) and np.array_equal(counts, want_c)
    assert counts.dtype == np.int64 and counts.max() > 1
    # two windows an anchor, less those over N and IUPAC codes
    assert 0.9 * 2 * seq.size < counts.sum() < 2 * seq.size


def _short(seed: int, n: int = 3_000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTacgtUu", np.uint8)[rng.integers(0, 10, n)].copy()
    seq[n // 3 : n // 3 + 300] = ord("A")
    seq[n // 2 : n // 2 + 30] = ord("N")
    seq[rng.integers(0, n, 5)] = np.frombuffer(b"RYKMS", np.uint8)
    seq[3 * n // 4 : 3 * n // 4 + 200] = seq[100:300]
    return seq


@pytest.mark.parametrize("k", [1, 2, 7, 8, 15])
def test_the_reference_is_brute_force(k):
    seq = _short(k)
    kmers, counts = ref.count_table(seq, k)
    want = brute_table(seq.tobytes(), k)
    assert [int(x) for x in kmers] == sorted(want)
    assert counts.tolist() == [want[x] for x in sorted(want)] and counts.max() > 1


def test_the_reference_translates_with_the_standard_code():
    assert ref.AA_CHARS == AA_CHARS
    codons = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"]
    assert len(ref.TABLE_1) == 64 and "".join(ref.TABLE_1[c] for c in codons) == NCBI_TABLE_1
    bases = "ACGT"
    for i, codon in enumerate(a + b + c for a in bases for b in bases for c in bases):
        assert AA_CHARS.index(ref.TABLE_1[codon]) == standard_genetic_code.aa_code(i), codon


@pytest.mark.parametrize("K", [7, 12])
def test_the_block_size_does_not_change_the_table(K):
    seq = _genome(40 + K, 6_000)
    want_k, want_c = ref.count_table(seq, K)
    for block in (97, 1_000, 4_096, 1 << 20):
        got_k, got_c = ref.count_table(seq, K, block=block)
        assert list(got_k) == list(want_k) and np.array_equal(got_c, want_c), block


@pytest.mark.parametrize("k", [3, 7])
def test_a_changed_base_changes_the_windows_over_it(k):
    seq = _short(50 + k)
    for pos, new in ((0, ord("C")), (1_000, ord("G")), (seq.size - 1, ord("T")), (seq.size // 2 + 5, ord("A"))):
        after = seq.copy()
        after[pos] = new
        table = brute_table(seq.tobytes(), k)
        table.subtract(int(x) for x in ref.window_keys(seq, pos, k))
        assert min(table.values()) >= 0
        table.update(int(x) for x in ref.window_keys(after, pos, k))
        assert +table == brute_table(after.tobytes(), k), pos


def test_the_seam_control_adds_each_seam_window_once_more():
    seq, k, chunk = _short(9, 6_000), 7, 1_000
    seams = range(chunk - 3 * k, seq.size - 3 * k + 1, chunk - 3 * k)
    seq[seams[1] + 3 * k - 1] = ord("N")
    plus = ref.seam_keys(seq, k, chunk)
    certain = [np.isin(seq[s : s + 3 * k], list(b"ACGTUacgtu")).all() for s in seams]
    assert 0 < sum(certain) < len(certain)
    # both strands' windows at each seam whose bases are all certain
    assert plus.size == 2 * sum(certain)
    with pytest.raises(ValueError):
        ref.count_table(seq, 33)


def _code(path: Path) -> str:
    """A module's source after its docstring."""
    tree = ast.parse(path.read_text())
    return ast.unparse(tree.body[1:])


def test_the_benchmarks_copy_is_the_same_code():
    assert _code(ROOT / "kmer_bench" / "reference" / "sixframe.py") == _code(ROOT / "reference" / "sixframe_aa.py")


@pytest.mark.parametrize("path", ["reference/sixframe_aa.py", "kmer_bench/reference/sixframe.py"])
def test_the_reference_imports_nothing_of_the_program(path):
    tree = ast.parse((ROOT / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if node.level == 0 else ".")
    assert names <= {"__future__", "contextlib", "os", "concurrent", "numpy", "torch"}, names
