"""``minimizer_select`` held against the plain minimizer reference
(``reference/minimizers.py``, plain torch, nothing of either package) on
the CPU: values and positions exactly, at (K, W) = (15, 10), (5, 3),
(21, 11), (31, 10) and (32, 5) (the last on K6's K = 32 instance), with
chunks of 2^12 windows (more than 40 seams) and with one chunk; the
reference's block size, its tie rule against the control's, and the
reference against the JAX package's ``minimizer_select``.  The CPU takes
the plain route, never K12: on K12's grid of (K, W), in both modes, it
matches the reference and the JAX package and counts no kernel window."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmers_tpu_torch.ops.kernels.minimizer_kernel import MAX_W, ChunkMinimizers
from kmers_tpu_torch.symbols import EncodeError
from kmers_tpu_torch.utils.profiling import counters, reset_counters

tex = importlib.import_module("kmers_tpu_torch.pipelines.extract")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from reference import minimizers as ref  # noqa: E402

KW = [(15, 10), (5, 3), (21, 11), (31, 10), (32, 5)]
#: windows a chunk in the walk's tests: 2^12, so ~48 chunks of 200 kb
SMALL_CHUNK = 1 << 12
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes torch's thread team only
    contends with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genome(seed: int, n: int = 200_000) -> np.ndarray:
    """Uniform ACGT with soft-masked runs, N blocks, IUPAC codes, U, a
    poly-A run and a CAGGT tandem repeat (every window of the last two
    ties)."""
    rng = np.random.default_rng(seed)
    seq = ACGT[rng.integers(0, 4, n)].copy()
    r = n // 100
    seq[30 * r : 32 * r] = ord("A")
    seq[32 * r : 34 * r] = np.resize(np.frombuffer(b"CAGGT", np.uint8), 2 * r)
    for a in rng.integers(0, 98 * r, 8):
        seq[a : a + rng.integers(r // 2, 2 * r)] |= 0x20
    for a in rng.integers(0, 99 * r, 5):
        seq[a : a + rng.integers(1, r)] = ord("N")
    seq[rng.integers(0, n, 20)] = np.frombuffer(b"RYKMSWryn-", np.uint8)[rng.integers(0, 10, 20)]
    seq[rng.integers(0, n, 20)] = np.frombuffer(b"Uu", np.uint8)[rng.integers(0, 2, 20)]
    return seq


GENOME = _genome(25)
CLEAN = np.frombuffer(b"ACGTacgt", np.uint8)[np.random.default_rng(26).integers(0, 8, 100_000)]


def _same(got, want):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("chunk", [SMALL_CHUNK, 1 << 30], ids=["48_chunks", "one_chunk"])
@pytest.mark.parametrize("K,W", KW)
def test_skip_ambiguous_matches_the_reference(monkeypatch, K, W, chunk):
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", chunk)
    got = tex.minimizer_select(GENOME, K, W, canonical=True, skip_ambiguous=True, device="cpu")
    _same(got, ref.minimizers(GENOME, K, W))
    assert got[1].size > GENOME.size // (W + 1) and (np.diff(got[1]) > 0).all()


@pytest.mark.parametrize("K,W", KW)
def test_strict_matches_the_reference(monkeypatch, K, W):
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", SMALL_CHUNK // 2)
    got = tex.minimizer_select(CLEAN, K, W, canonical=True, skip_ambiguous=False, device="cpu")
    _same(got, ref.minimizers(CLEAN, K, W))


def test_forward_values_match_the_reference(monkeypatch):
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", SMALL_CHUNK)
    got = tex.minimizer_select(GENOME, 15, 10, canonical=False, skip_ambiguous=True, device="cpu")
    _same(got, ref.minimizers(GENOME, 15, 10, canonical=False))


@pytest.mark.parametrize("chunk", [1, 7, SMALL_CHUNK])
def test_ties_and_no_candidate_windows_across_seams(monkeypatch, chunk):
    """The poly-A run, the tandem repeat and an N block, with seams inside
    each: every window of the first two ties, the N block's windows pick
    nothing."""
    seq = np.concatenate([ACGT[np.random.default_rng(3).integers(0, 4, 300)],
                          np.full(200, ord("A"), np.uint8), np.full(60, ord("N"), np.uint8),
                          np.resize(np.frombuffer(b"CAGGT", np.uint8), 400)])
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", chunk)
    got = tex.minimizer_select(seq, 15, 10, skip_ambiguous=True, device="cpu")
    want = ref.minimizers(seq, 15, 10)
    _same(got, want)
    rightmost = ref.minimizers(seq, 15, 10, rightmost=True)
    assert not np.array_equal(rightmost[1], want[1])


def test_the_error_contract_holds_across_chunks(monkeypatch):
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", SMALL_CHUNK)
    bad = CLEAN.copy()
    bad[-100] = ord("X")
    with pytest.raises(EncodeError):
        tex.minimizer_select(bad, 15, 10, skip_ambiguous=True, device="cpu")
    amb = CLEAN.copy()
    amb[-100] = ord("N")
    with pytest.raises(EncodeError):
        tex.minimizer_select(amb, 15, 10, skip_ambiguous=False, device="cpu")
    _same(tex.minimizer_select(amb, 15, 10, skip_ambiguous=True, device="cpu"), ref.minimizers(amb, 15, 10))


def test_the_block_size_does_not_change_the_reference():
    want = ref.window_picks(GENOME[:50_000], 15, 10)
    for block in (37, 999, 1 << 12):
        got = ref.window_picks(GENOME[:50_000], 15, 10, block=block)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert (want[1] == -1).any() and want[1].size == 50_000 - 15 - 10 + 2


def test_the_reference_matches_the_jax_package():
    jex = importlib.import_module("kmers_tpu.pipelines.extract")
    seq = GENOME[29_000:41_000]
    for K, W in [(15, 10), (32, 5)]:
        _same(ref.minimizers(seq, K, W), jex.minimizer_select(seq, K, W, True, skip_ambiguous=True))


def test_the_reference_imports_nothing_of_the_program():
    import ast

    for path in (ROOT / "reference" / "minimizers.py", ROOT / "kmer_bench" / "reference" / "minimizers.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert names <= {"__future__", "concurrent", "contextlib", "numpy", "os", "torch"}, path


def test_the_benchmarks_frozen_copy_agrees():
    from kmer_bench.reference import minimizers as frozen

    for rightmost in (False, True):
        got = frozen.minimizers(GENOME[:60_000], 15, 10, rightmost=rightmost)
        _same(got, ref.minimizers(GENOME[:60_000], 15, 10, rightmost=rightmost))


#: K12's grid: K at both ends of its register range and minimap2's; W from
#: one k-mer to the kernel's cap
K12_GRID = [(K, W) for K in (1, 15, 31) for W in (1, 2, 10, 64, MAX_W)]


@pytest.mark.parametrize("skip", [True, False], ids=["skipping", "strict"])
@pytest.mark.parametrize("K,W", K12_GRID)
def test_the_plain_route_on_k12s_grid(monkeypatch, K, W, skip):
    """On the CPU every (K, W) takes the plain route (no K12 launch, 0
    ``minimizer_kernel_windows``) and matches the reference and the JAX
    package, across seams of an odd chunk."""
    jex = importlib.import_module("kmers_tpu.pipelines.extract")
    seq = GENOME[29_000:33_000] if skip else CLEAN[:4_000]
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", 1_001)
    launches = ChunkMinimizers.launches
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tex.minimizer_select(seq, K, W, canonical=True, skip_ambiguous=skip, device="cpu")
    totals = counters()
    assert ChunkMinimizers.launches == launches
    assert totals["minimizer_kernel_windows"] == 0
    assert totals["minimizer_windows"] == seq.size - K - W + 2
    assert got[1].size > 0 and "minimizers_selected" not in totals
    _same(got, ref.minimizers(seq, K, W))
    _same(got, jex.minimizer_select(seq, K, W, True, skip_ambiguous=skip))


@pytest.mark.parametrize("sentinel", [True, False])
@pytest.mark.parametrize("W", [1, 10, MAX_W, MAX_W + 1])
def test_cpu_tensors_never_take_k12(W, sentinel):
    assert not ChunkMinimizers(W, True, sentinel, 1 << 10, torch.device("cpu")).kernel
