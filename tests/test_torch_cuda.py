"""The port's CUDA kernels against their plain versions, bit-exact, on the
card.  Every test carries the ``cuda`` marker and skips without a CUDA
device; run them on a GPU host with ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import collections
import contextlib
import ctypes
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kmers_tpu_torch.convert import SENTINEL
from kmers_tpu_torch.ops.kernels.general_kernel import (
    windows_general,
    windows_general_plain,
    windows_k32,
    windows_k32_plain,
)
from kmers_tpu_torch.ops.kernels.merge_kernel import (
    MERGE_TILE,
    MERGE_WORDS,
    compact_table,
    compact_table_plain,
    merge_reduce_tables,
    merge_reduce_tables_plain,
    merge_tables,
    merge_tables_mw,
    merge_tables_mw_plain,
    merge_tables_plain,
)
from kmers_tpu_torch.ops.kernels.minimizer_kernel import MAX_W, ChunkMinimizers
from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words, canonical_words_plain
from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain
from kmers_tpu_torch.ops.kernels.sort_kernel import (
    MAX_TILE,
    bitonic_local_sort,
    bitonic_local_sort_plain,
    bitonic_sort,
    bitonic_sort_plain,
)
from kmers_tpu_torch.ops.kernels.sixframe_kernel import (
    sixframe_windows,
    sixframe_windows_plain,
    sixframe_words,
    sixframe_words_plain,
)
from kmers_tpu_torch.ops.kernels.window_kernel import (
    TILE,
    canonical_hashes,
    canonical_hashes_plain,
    canonical_windows,
    canonical_windows_plain,
)
from kmers_tpu_torch.genetic_codes import ncbi_trans_table
from kmers_tpu_torch.pipelines import extract as tex
from kmers_tpu_torch.pipelines import minhash as tmh
from kmers_tpu_torch.pipelines._input import download
from kmers_tpu_torch.pipelines.canonical_count import (
    CountConfig,
    canonical_count_bytes,
    composition_vector,
)
from kmers_tpu_torch.pipelines.sixframe import SixFrameCountConfig, sixframe_aa_count
from kmers_tpu_torch.pipelines.streaming import StreamingCounter
from kmers_tpu_torch.pipelines.tables import merge_counts_device
from kmers_tpu_torch.utils import profiling
from kmers_tpu_torch.utils.profiling import counters, reset_counters

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from reference import sixframe_aa  # noqa: E402

pytestmark = pytest.mark.cuda

POOL = np.frombuffer(b"ACGTacgtuNRYKM-", dtype=np.uint8)


@pytest.fixture
def cuda():
    # decided inside the fixture, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(L, seed, invalid=False):
    rng = np.random.default_rng(seed)
    p = np.full(len(POOL), 0.02)
    p[:8] = 0.1
    b = POOL[rng.choice(len(POOL), size=L, p=p / p.sum())]
    b[rng.random(L) < 0.002] = ord("N")
    if invalid and L:
        b[L // 2] = ord("X")
    return b


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("K", [1, 15, 31])
@pytest.mark.parametrize("L", [1, 30, 255, 256, 257, 5003, (1 << 20) - 30])
def test_window_kernel_matches_plain(cuda, K, L):
    b = torch.from_numpy(_bytes(L, L + K, invalid=True)).to(cuda)
    before = canonical_windows.launches
    got = canonical_windows(b, K)
    torch.cuda.synchronize()
    assert canonical_windows.launches == before + 1
    _assert_same(got, canonical_windows_plain(b.cpu(), K))


@pytest.mark.parametrize("offset", [1, 3, 1000001])
def test_window_kernel_on_unaligned_views(cuda, offset):
    buf = torch.from_numpy(_bytes(1 << 21, offset)).to(cuda)
    view = buf[offset : offset + (1 << 20)]
    got = canonical_windows(view, 31)
    torch.cuda.synchronize()
    _assert_same(got, canonical_windows_plain(view.cpu(), 31))


def _rle_cases(rng):
    n = 1 << 20
    long_run = torch.zeros(n, dtype=torch.int64)
    long_run[: n // 2] = 7
    long_run[n // 2 :] = torch.arange(n // 2) + 8
    edges = torch.repeat_interleave(torch.arange(4096), 256)  # runs of one block
    straddle = torch.repeat_interleave(torch.arange(3000), 333)
    tail = torch.sort(torch.from_numpy(rng.integers(0, 1 << 40, 50000))).values
    tail[-1234:] = SENTINEL
    return {
        "long_run": long_run,
        "block_edges": edges,
        "straddle": straddle,
        "sentinel_tail": tail,
        "all_unique": torch.arange(777) * 3,
        "all_sentinel": torch.full((300,), SENTINEL),
        "one": torch.tensor([5]),
        "empty": torch.zeros(0, dtype=torch.int64),
    }


@pytest.mark.parametrize(
    "name",
    ["long_run", "block_edges", "straddle", "sentinel_tail", "all_unique",
     "all_sentinel", "one", "empty"],
)
def test_rle_kernel_matches_plain(cuda, name):
    keys = _rle_cases(np.random.default_rng(5))[name]
    before = rle_unit.launches
    got = rle_unit(keys.to(cuda))
    torch.cuda.synchronize()
    assert rle_unit.launches == before + (1 if keys.numel() else 0)
    _assert_same(got, rle_unit_plain(keys))


def test_slice_on_cuda_matches_cpu(cuda):
    data = _bytes(1_000_000, 11)
    cfg = CountConfig(K=31, chunk_size=1 << 18)
    k0, w0 = canonical_windows.launches, rle_unit.launches
    m0, c0 = merge_reduce_tables.launches, compact_table.launches
    got = canonical_count_bytes(data, cfg, device="cuda")
    assert canonical_windows.launches - k0 == 4 and rle_unit.launches - w0 == 4
    # the fold: 4 chunk compactions (K10), 3 merges of one K9 merge-reduce each
    assert merge_reduce_tables.launches - m0 == 3 and compact_table.launches - c0 == 4
    want = canonical_count_bytes(data, cfg, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("K", [32, 33, 47, 62, 63])
@pytest.mark.parametrize("L", [1, 31, 255, 256, 257, 5003, (1 << 19) - 46])
def test_multiword_kernel_matches_plain(cuda, K, L):
    b = torch.from_numpy(_bytes(L, L + K, invalid=True)).to(cuda)
    before = canonical_words.launches
    got = canonical_words(b, K)
    torch.cuda.synchronize()
    assert canonical_words.launches == before + 1
    _assert_same(got, canonical_words_plain(b.cpu(), K))


@pytest.mark.parametrize("offset", [1, 3, 524243])
def test_multiword_kernel_on_unaligned_views(cuda, offset):
    buf = torch.from_numpy(_bytes(1 << 20, offset)).to(cuda)
    view = buf[offset : offset + (1 << 19)]
    got = canonical_words(view, 47)
    torch.cuda.synchronize()
    _assert_same(got, canonical_words_plain(view.cpu(), 47))


def _string_counter(text, k):
    """{canonical register: count} from Python strings alone."""
    text = text.upper().replace("U", "T")
    comp = str.maketrans("ACGT", "TGCA")
    digits = str.maketrans("ACGT", "0123")
    out = collections.Counter()
    for i in range(len(text) - k + 1):
        w = text[i : i + k]
        if set(w) <= {"A", "C", "G", "T"}:
            out[int(min(w, w.translate(comp)[::-1]).translate(digits), 4)] += 1
    return dict(out)


@pytest.mark.parametrize("K", [47, 80])
def test_multiword_slice_on_cuda_matches_string_counter(cuda, K):
    rng = np.random.default_rng(K)
    data = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, 60_000)]
    data[rng.integers(0, data.size, 30)] = ord("N")
    data[20_000:20_500] = data[:500]  # a repeat across chunks
    cfg = CountConfig(K=K, chunk_size=1 << 13)
    k3, w0 = canonical_words.launches, rle_unit.launches
    kmers, counts = canonical_count_bytes(data, cfg, device="cuda")
    n_chunks = len(range(0, data.size - K + 1, (1 << 13) - (K - 1)))
    assert canonical_words.launches - k3 == (n_chunks if K <= 63 else 0)
    assert rle_unit.launches - w0 == n_chunks
    assert kmers.dtype == object and counts.max() >= 2
    assert dict(zip(kmers.tolist(), counts.tolist())) == _string_counter(data.tobytes().decode(), K)


@pytest.mark.parametrize("K", [1, 21, 31])
@pytest.mark.parametrize("L", [1, 30, 255, 257, 5003, (1 << 20) - 30])
def test_window_kernel_hash_mode_matches_plain(cuda, K, L):
    b = torch.from_numpy(_bytes(L, 3 * L + K, invalid=True)).to(cuda)
    before = canonical_hashes.launches
    got = canonical_hashes(b, K)
    torch.cuda.synchronize()
    assert canonical_hashes.launches == before + 1
    _assert_same(got, canonical_hashes_plain(b.cpu(), K))


@pytest.mark.parametrize("offset", [1, 3, 1000001])
def test_window_kernel_hash_mode_on_unaligned_views(cuda, offset):
    buf = torch.from_numpy(_bytes(1 << 21, offset)).to(cuda)
    view = buf[offset : offset + (1 << 20)]
    got = canonical_hashes(view, 21)
    torch.cuda.synchronize()
    _assert_same(got, canonical_hashes_plain(view.cpu(), 21))
    # the error counters are those of the register mode on the same view
    _assert_same(got[1:], canonical_windows(view, 21)[1:])


#: K1 (both modes) and K3 at the edges of their packed tiles: TILE positions
#: a block, 32 bytes a code word, one (K1) or two (K3) halo words
FRONTENDS = {
    "K1": (canonical_windows, canonical_windows_plain, [1, 2, 15, 16, 31]),
    "K1 hash": (canonical_hashes, canonical_hashes_plain, [1, 2, 15, 16, 31]),
    "K3": (canonical_words, canonical_words_plain, [32, 33, 47, 62, 63]),
}
EDGE_LENGTHS = {"K-1": -1, "K": 0, "K+1": 1, "31": 31, "32": 32, "33": 33, "TILE-1": TILE - 1,
                "TILE": TILE, "TILE+1": TILE + 1, "2^20-30": (1 << 20) - 30}
EDGE_OFFSETS = [*range(1, 16), 17]
EDGE_CASES = ["flags at word and tile edges", "N runs across code words",
              *(f"length {name}" for name in EDGE_LENGTHS), *(f"offset {o}" for o in EDGE_OFFSETS)]


def _edge_input(case, K, device):
    rng = np.random.default_rng(K)
    certain = np.frombuffer(b"ACGTacgtu", np.uint8)
    if case.startswith("length"):
        n = EDGE_LENGTHS[case.split()[1]]
        b = certain[rng.integers(0, 9, n + K if n < 31 else n)]
        if b.size > 40:
            b[b.size // 3] = ord("N")
        return torch.from_numpy(b).to(device)
    if case.startswith("offset"):
        # a view of one buffer, unaligned; several tiles and a ragged end
        o = int(case.split()[1])
        buf = torch.from_numpy(_bytes(5 * TILE, K, invalid=True)).to(device)
        return buf[o : o + 4 * TILE - 5]
    L = 3 * TILE + 5
    b = certain[rng.integers(0, 9, L)]
    if case.startswith("flags"):
        edges = (0, 31, 32, 63, 64, TILE - 1, TILE, 2 * TILE - 1, 2 * TILE, L - 1)
        b[list(edges)] = np.frombuffer(b"NXR-nkYxmN", np.uint8)
    else:
        b[20:50] = ord("N")  # across the first code words' boundary
        b[96:128] = ord("n")  # exactly one code word
        b[TILE - 10 : TILE + 40] = ord("N")  # across a tile's edge, in its halo
        b[2 * TILE - 40 : 2 * TILE + 100] = ord("N")  # through a tile's halo words
    return torch.from_numpy(b).to(device)


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("kernel,K", [(name, K) for name, (_, _, ks) in FRONTENDS.items() for K in ks])
def test_frontend_kernels_at_tile_edges(cuda, kernel, K, case):
    wrapper, plain, _ = FRONTENDS[kernel]
    b = _edge_input(case, K, cuda)
    before = wrapper.launches
    got = wrapper(b, K)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (1 if b.numel() else 0)
    _assert_same(got, plain(b.cpu(), K))


GENERAL_CASES = [(2, 31, True), (2, 16, False), (4, 15, True), (4, 9, False), (8, 7, False), (2, 1, True)]


def _general_input(L, bps, seed):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 1 << bps, L).astype(np.uint8))
    good = torch.from_numpy(rng.random(L) > 0.005)
    return codes, good


@pytest.mark.parametrize("bps,K,canonical", GENERAL_CASES)
@pytest.mark.parametrize("L", [1, 30, 256, 257, 5003, (1 << 20) + 3])
def test_general_kernel_matches_plain(cuda, bps, K, canonical, L):
    codes, good = _general_input(L, bps, L + K)
    before = windows_general.launches
    got = windows_general(codes.to(cuda), good.to(cuda), K, bps, canonical)
    torch.cuda.synchronize()
    assert windows_general.launches == before + 1
    _assert_same([got], [windows_general_plain(codes, good, K, bps, canonical)])


@pytest.mark.parametrize("bps,K,canonical", GENERAL_CASES)
@pytest.mark.parametrize("offset", [1, 7, 99999])
def test_general_kernel_on_odd_offsets(cuda, bps, K, canonical, offset):
    codes, good = _general_input(1 << 18, bps, offset)
    c, g = codes.to(cuda)[offset:], good.to(cuda)[offset:]
    got = windows_general(c, g, K, bps, canonical)
    torch.cuda.synchronize()
    _assert_same([got], [windows_general_plain(c.cpu(), g.cpu(), K, bps, canonical)])


#: K6 and K8b at the edges of their packed code tiles (TILE positions a
#: block, 32 symbols a group, one halo group): the inputs of
#: tests/test_torch_general_edges.py, each case alone, and views of one
#: buffer at odd offsets; (bps, K, canonical), K = 32 is K8b
GENERAL_EDGE_CONFIGS = [(2, 1, True), (2, 16, False), (2, 31, True), (2, 31, False), (4, 1, True),
                        (4, 8, False), (4, 15, True), (8, 1, False), (8, 4, False), (8, 7, False),
                        (2, 32, False), (2, 32, True)]
GENERAL_EDGE_LENGTHS = {"K-1": -1, "K": 0, "K+1": 1, "31": 31, "32": 32, "33": 33, "1023": 1023,
                        "1024": 1024, "1025": 1025, "1056": 1056, "2^20-1": (1 << 20) - 1,
                        "2^20+1": (1 << 20) + 1}
GENERAL_EDGE_CASES = ["bad at group, tile and halo edges", "bad runs across groups and tiles",
                      "codes at the top of their range",
                      *(f"length {n}" for n in GENERAL_EDGE_LENGTHS),
                      *(f"offset {o}" for o in [*EDGE_OFFSETS, 33])]


@functools.cache
def _general_edge_cases(bps, K):
    """{case: (codes, good)} as numpy, the same as the CPU tests'."""
    rng = np.random.default_rng(100 * bps + K)
    top = (1 << bps) - 1

    def stream(L):
        return rng.integers(0, top + 1, L).astype(np.uint8), rng.random(L) > 0.002

    L = 3 * TILE + 5
    codes, good = stream(L)
    good[[0, 31, 32, 63, 64, TILE - 1, TILE, TILE + 1, TILE + K - 2, TILE + 31, 2 * TILE - 1,
          2 * TILE, 2 * TILE + K - 2, L - 1]] = False
    cases = {GENERAL_EDGE_CASES[0]: (codes, good)}
    codes, good = stream(L)
    good[20:50] = False  # across the first groups' boundary
    good[96:128] = False  # exactly one group
    good[TILE - 10 : TILE + 40] = False  # across a tile's edge, in its halo
    good[2 * TILE - 40 : 2 * TILE + 100] = False
    cases[GENERAL_EDGE_CASES[1]] = (codes, good)
    codes = np.full(2 * TILE + 77, top, np.uint8)
    good = np.ones(codes.size, bool)
    good[[TILE // 2, TILE + 3]] = False
    cases[GENERAL_EDGE_CASES[2]] = (codes, good)
    for name, n in GENERAL_EDGE_LENGTHS.items():
        codes, good = stream(K + n if n < 31 else n)
        if codes.size > 40:
            good[codes.size // 3] = False
        cases[f"length {name}"] = (codes, good)
    return cases


def _general_edge_input(case, bps, K, device):
    if case.startswith("offset"):
        # a view of one buffer, unaligned; several tiles and a ragged end
        o = int(case.split()[1])
        codes, good = _general_input(5 * TILE, bps, 1000 * bps + K)
        return codes.to(device)[o : o + 4 * TILE - 5], good.to(device)[o : o + 4 * TILE - 5]
    codes, good = _general_edge_cases(bps, K)[case]
    return torch.from_numpy(codes).to(device), torch.from_numpy(good).to(device)


@pytest.mark.parametrize("case", GENERAL_EDGE_CASES)
@pytest.mark.parametrize("bps,K,canonical", GENERAL_EDGE_CONFIGS)
def test_general_kernels_at_tile_edges(cuda, bps, K, canonical, case):
    codes, good = _general_edge_input(case, bps, K, cuda)
    wrapper = windows_k32 if K == 32 else windows_general
    before = wrapper.launches
    if K == 32:
        got = windows_k32(codes, good, canonical)
        want = windows_k32_plain(codes.cpu(), good.cpu(), canonical)
    else:
        got = [windows_general(codes, good, K, bps, canonical)]
        want = [windows_general_plain(codes.cpu(), good.cpu(), K, bps, canonical)]
    torch.cuda.synchronize()
    assert wrapper.launches == before + (1 if codes.numel() else 0)
    _assert_same(got, want)


@pytest.mark.parametrize("K,s", [(21, 1000), (31, 50), (32, 200), (11, 2000)])
def test_minhash_on_cuda_matches_cpu(cuda, K, s):
    data = _bytes(300_000, K)
    data[data == ord("X")] = ord("A")
    before = canonical_hashes.launches
    got = tmh.minhash_sketch(data, K=K, s=s, device="cuda")
    assert canonical_hashes.launches - before == (1 if K <= 31 else 0)
    assert np.array_equal(got, tmh.minhash_sketch(data, K=K, s=s, device="cpu"))


def test_minhash_fallback_and_streaming_on_cuda(cuda):
    rng = np.random.default_rng(4)
    data = np.resize(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 300)], 200_000)
    assert np.array_equal(
        tmh.minhash_sketch(data, K=21, s=500, device="cuda"), tmh.minhash_sketch(data, K=21, s=500, device="cpu")
    )
    seq = _bytes(100_000, 5)
    seq[seq == ord("X")] = ord("C")
    offsets = np.array([0, 10, 40_000, 40_001, 100_000])
    sketches = []
    for dev in ("cuda", "cpu"):
        sk = tmh.StreamingSketcher(K=19, s=300, chunk_size=1 << 14, device=dev)
        sk.update(seq, offsets)
        sketches.append(sk.finalize())
    assert np.array_equal(*sketches)


@pytest.mark.parametrize("K,canonical", [(31, False), (15, True), (32, True), (32, False)])
def test_extract_on_cuda_matches_cpu(cuda, K, canonical):
    data = _bytes(500_000, K)
    data[data == ord("X")] = ord("G")
    before = windows_general.launches, windows_k32.launches
    got = tex.extract_kmers(data, K=K, canonical=canonical, device="cuda")
    # K <= 31 launches K6, K = 32 its K = 32 instance (K8b)
    assert (windows_general.launches - before[0], windows_k32.launches - before[1]) == (
        (1, 0) if K <= 31 else (0, 1))
    want = tex.extract_kmers(data, K=K, canonical=canonical, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got = tex.minimizer_select(data, K=K, W=10, canonical=canonical, skip_ambiguous=True, device="cuda")
    want = tex.minimizer_select(data, K=K, W=10, canonical=canonical, skip_ambiguous=True, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def chromosome_2mb():
    """A 2-Mb cut of the benchmark generator's chromosome (chr21's keys):
    soft masks, N blocks, IUPAC codes, repeats, the poly-A and tandem run."""
    import json

    from kmer_bench.gen import rng_for, synth_chromosome

    traffic = json.loads((ROOT / "kmer_bench" / "traffic" / "chr21.json").read_text())
    traffic.update(bases=2_000_000, big_n_block=15_000, low_complexity=20_000)
    return synth_chromosome(traffic, rng_for(25, 1))


@pytest.mark.parametrize("K,W", [(15, 10), (21, 11), (32, 5)])
def test_minimizer_walk_on_cuda_matches_the_reference(cuda, monkeypatch, chromosome_2mb, K, W):
    from reference import minimizers as ref

    # chunks of 2^17 windows: 16 chunks, 15 seams
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", 1 << 17)
    n_chunks = -(-(chromosome_2mb.size - K - W + 2) // (1 << 17))
    assert n_chunks >= 9
    before = windows_general.launches, windows_k32.launches, ChunkMinimizers.launches
    got = tex.minimizer_select(chromosome_2mb, K=K, W=W, canonical=True, skip_ambiguous=True, device="cuda")
    launches = (windows_general.launches - before[0], windows_k32.launches - before[1],
                ChunkMinimizers.launches - before[2])
    # K <= 31: K6, then K12, once a chunk; K = 32: K8b and the plain route
    assert launches == ((n_chunks, 0, n_chunks) if K <= 31 else (0, n_chunks, 0))
    want = ref.minimizers(chromosome_2mb, K, W)
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _minimizer_input(L, seed, skip):
    """Soft-masked ACGT with a poly-A run (every key of its windows ties);
    with ``skip`` also N blocks longer than the widest window (windows with
    no candidate) and IUPAC codes."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, L)].copy()
    seq[L // 5 : L // 5 + 600] = ord("A")
    if skip:
        for a, n in ((L // 3, 700), (L // 2, 300), ((3 * L) // 4, 9)):
            seq[a : a + n] = ord("N")
        seq[rng.integers(0, L, 20)] = ord("R")
    return seq


def _minimizers_on_cuda(monkeypatch, seq, K, W, skip):
    """``minimizer_select`` of ``seq`` on the card: its rows, its launches
    of K6, K8b and K12, and its counters.  The counters count as if a
    profiler recorded: a profiler of the host alone here would keep a later
    profiler in the process from seeing the card."""
    before = windows_general.launches, windows_k32.launches, ChunkMinimizers.launches
    reset_counters()
    with monkeypatch.context() as m:
        m.setattr(profiling, "_profiler_enabled", lambda: True)
        got = tex.minimizer_select(seq, K=K, W=W, canonical=True, skip_ambiguous=skip, device="cuda")
    totals = counters()
    launches = (windows_general.launches - before[0], windows_k32.launches - before[1],
                ChunkMinimizers.launches - before[2])
    return got, launches, totals


def _same_rows(got, *wants):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    for want in wants:
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("skip", [True, False], ids=["skipping", "strict"])
@pytest.mark.parametrize("W", [1, 2, 10, 64, MAX_W])
@pytest.mark.parametrize("K", [1, 15, 31])
@pytest.mark.parametrize("chunk", [4_099, 1 << 24], ids=["seams", "one_chunk"])
def test_minimizer_kernel_matches_cpu_and_the_reference(cuda, monkeypatch, chunk, K, W, skip):
    """K12 against the CPU's plain route and the plain reference, bit for
    bit, on ~10 tiles of 2,048 windows: in chunks of 4,099 windows (seams
    inside tiles) and whole; K6 and K12 once a chunk; the counters."""
    from reference import minimizers as ref

    seq = _minimizer_input(20_000, K * 1000 + W, skip)
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", chunk)
    n_win = seq.size - K - W + 2
    n_chunks = -(-n_win // chunk)
    got, launches, totals = _minimizers_on_cuda(monkeypatch, seq, K, W, skip)
    assert launches == (n_chunks, 0, n_chunks)
    assert totals["minimizer_kernel_windows"] == totals["minimizer_windows"] == n_win
    assert totals["minimum_rows"] == got[1].size > 0
    want = tex.minimizer_select(seq, K=K, W=W, canonical=True, skip_ambiguous=skip, device="cpu")
    _same_rows(got, want, ref.minimizers(seq, K, W))


def _pinned_download(monkeypatch, nbytes):
    """``download`` of an int64 card tensor of ``nbytes`` bytes with the
    counters on, as in :func:`_minimizers_on_cuda`: the array and the
    counters."""
    t = torch.arange(nbytes // 8, dtype=torch.int64, device="cuda")
    reset_counters()
    with monkeypatch.context() as m:
        m.setattr(profiling, "_profiler_enabled", lambda: True)
        arr = download(t)
    return arr, counters()


def test_each_chunk_prefetches_its_scalars_into_pinned_memory(cuda, monkeypatch):
    """The drain queue's copy of each chunk's scalars (span
    ``kmers.prefetch``) holds its pinned allocation (``kmers.pin``); the
    result, under 1 MiB, comes back pageable."""
    entered = []

    @contextlib.contextmanager
    def record(name):
        entered.append(name)
        yield
        entered.append("/" + name)

    data = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, 2500)]
    reset_counters()
    with monkeypatch.context() as m:
        m.setattr(profiling, "_profiler_enabled", lambda: True)
        m.setattr(profiling, "record_function", record)
        got = canonical_count_bytes(data, CountConfig(K=15, chunk_size=1000), device="cuda")
    totals = counters()
    want = canonical_count_bytes(data, CountConfig(K=15, chunk_size=1000), device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    at = [i for i, name in enumerate(entered) if name == "kmers.prefetch"]
    assert len(at) == 3 and all(entered[i : i + 4] == ["kmers.prefetch", "kmers.pin", "/kmers.pin", "/kmers.prefetch"]
                                for i in at)
    # three int64 scalars a chunk: distinct, invalid and ambiguous counts
    assert totals["pinned_bytes"] == 3 * 3 * 8 and "download_pinned_bytes" not in totals


def test_a_pinned_download_counts_the_bytes_it_asked_for(cuda, monkeypatch):
    arr, totals = _pinned_download(monkeypatch, 3 << 20)
    assert torch.from_numpy(arr).is_pinned()
    assert totals["pinned_bytes"] == totals["download_pinned_bytes"] == 3 << 20
    # a cached block serves it (0), or a new one rounded to a power of two
    assert totals["pinned_new_bytes"] in (0, 4 << 20)


def test_a_freed_pinned_block_serves_the_next_download_of_its_size(cuda, monkeypatch):
    # sizes of a bucket (128 MiB) no other download of these tests uses
    nbytes = (1 << 26) + 8
    first, _ = _pinned_download(monkeypatch, nbytes)
    del first
    second, totals = _pinned_download(monkeypatch, nbytes)
    assert torch.from_numpy(second).is_pinned()
    assert totals["pinned_bytes"] == nbytes and totals["pinned_new_bytes"] == 0


def test_a_held_pinned_block_makes_the_next_download_pin_anew(cuda, monkeypatch):
    # the 256-MiB bucket: the cache holds no free block of it
    nbytes = (1 << 27) + 8
    first, _ = _pinned_download(monkeypatch, nbytes)
    second, totals = _pinned_download(monkeypatch, nbytes)
    assert first.ctypes.data != second.ctypes.data
    assert totals["pinned_bytes"] == nbytes and totals["pinned_new_bytes"] == 1 << 28


@pytest.mark.parametrize("chunk", [1, 7, 2_047, 2_048, 2_049])
@pytest.mark.parametrize("K,W", [(15, 10), (31, 64), (1, 2)])
def test_minimizer_kernel_at_small_odd_chunks(cuda, monkeypatch, K, W, chunk):
    """Seams at every window (chunk 1), at a small odd stride and around
    one tile, over the poly-A run and N blocks."""
    from reference import minimizers as ref

    seq = _minimizer_input(3_000 if chunk < 100 else 12_000, 7, True)
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", chunk)
    got, launches, totals = _minimizers_on_cuda(monkeypatch, seq, K, W, True)
    assert launches[2] == -(-(seq.size - K - W + 2) // chunk)
    want = tex.minimizer_select(seq, K=K, W=W, canonical=True, skip_ambiguous=True, device="cpu")
    _same_rows(got, want, ref.minimizers(seq, K, W))


@pytest.mark.parametrize("skip", [True, False], ids=["skipping", "strict"])
@pytest.mark.parametrize("extra", [-1, 0, 1, 40])
def test_minimizer_kernel_on_inputs_of_about_one_window(cuda, monkeypatch, extra, skip):
    """Shorter than one window (nothing), one window, two, and a few."""
    from reference import minimizers as ref

    K, W = 15, 10
    seq = _minimizer_input(K + W - 1 + extra, 3, False)
    got, launches, totals = _minimizers_on_cuda(monkeypatch, seq, K, W, skip)
    assert launches[2] == (extra >= 0)
    assert (got[1].size > 0) == (extra >= 0)
    want = tex.minimizer_select(seq, K=K, W=W, canonical=True, skip_ambiguous=skip, device="cpu")
    _same_rows(got, want, ref.minimizers(seq, K, W))


@pytest.mark.parametrize("K,W", [(15, MAX_W + 1), (31, 300), (32, 10), (32, MAX_W)])
def test_wide_windows_and_k32_take_the_plain_route_on_cuda(cuda, monkeypatch, K, W):
    """Above the cap, and at K = 32 (a validity plane, no sentinel), the
    card runs the plain route: no K12 launch, 0 kernel windows."""
    from reference import minimizers as ref

    seq = _minimizer_input(12_000, K + W, True)
    monkeypatch.setattr(tex, "MINIMIZER_CHUNK_WINDOWS", 4_099)
    n_chunks = -(-(seq.size - K - W + 2) // 4_099)
    got, launches, totals = _minimizers_on_cuda(monkeypatch, seq, K, W, True)
    assert launches == ((n_chunks, 0, 0) if K <= 31 else (0, n_chunks, 0))
    assert totals["minimizer_kernel_windows"] == 0
    want = tex.minimizer_select(seq, K=K, W=W, canonical=True, skip_ambiguous=True, device="cpu")
    _same_rows(got, want, ref.minimizers(seq, K, W))


def test_spaced_syncmers_and_composition_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(6)
    clean = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, 200_000)]
    for fn, args in [
        (tex.spaced_kmers, (clean, 21, 7, True)),
        (tex.syncmer_select, (clean, 15, 5, True)),
        (tex.minimizer_select, (clean, 15, 10, True, False)),
        (composition_vector, (clean, 6, False)),
        (composition_vector, (clean, 6, True)),
    ]:
        got, want = fn(*args, device="cuda"), fn(*args, device="cpu")
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), fn.__name__


SIXFRAME_KS = [1, 2, 5, 7, 8, 10, 15, 23, 31, 32]


def _aa_bytes(L, seed):
    """Certain bases in either case with sparse N/IUPAC/invalid bytes, so
    that windows of 3 * 32 bases survive."""
    rng = np.random.default_rng(seed)
    b = np.frombuffer(b"ACGTacgtU", np.uint8)[rng.integers(0, 9, L)]
    junk = rng.random(L) < 0.003
    b[junk] = np.frombuffer(b"NRX-", np.uint8)[rng.integers(0, 4, int(junk.sum()))]
    return b


def _sixframe_wrappers(K):
    if K <= 7:
        return sixframe_windows, sixframe_windows_plain
    return sixframe_words, sixframe_words_plain


@pytest.mark.parametrize("K", SIXFRAME_KS)
@pytest.mark.parametrize("L", [1, 3 * 32 - 1, 255, 256, 257, 5003, (1 << 20) - 20])
def test_sixframe_kernels_match_plain(cuda, K, L):
    b = torch.from_numpy(_aa_bytes(L, L + K)).to(cuda)
    kernel, plain = _sixframe_wrappers(K)
    # the strands clipped differently, as the JAX kernel's callers clip them
    bounds = (3 * K, L - 5, 1, L // 2)
    before = kernel.launches
    got = kernel(b, K, bounds)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _assert_same(got, plain(b.cpu(), K, bounds))


@pytest.mark.parametrize("K", SIXFRAME_KS)
@pytest.mark.parametrize("offset", [1, 3, 99999])
def test_sixframe_kernels_on_odd_offsets(cuda, K, offset):
    buf = torch.from_numpy(_aa_bytes(1 << 19, offset)).to(cuda)
    view = buf[offset : offset + (1 << 18) - 7]
    kernel, plain = _sixframe_wrappers(K)
    bounds = (0, view.shape[0], 0, view.shape[0])
    got = kernel(view, K, bounds, ncbi_trans_table[2])
    torch.cuda.synchronize()
    _assert_same(got, plain(view.cpu(), K, bounds, ncbi_trans_table[2]))
    assert int(got[1]) > 0


#: K4 and K5 at the edges of their frame-major tiles: TILE anchors a block,
#: 32 bytes a code word, a halo of 3K - 1 bytes, codons in three frames
SIXFRAME_EDGE_CASES = ["flags at word and tile edges", "N runs across code words and tiles",
                       "bounds outside the input",
                       *(f"length {n}" for n in ("3K-1", "3K", "1023", "1024", "1025", "2^20-30")),
                       *(f"offset {o}" for o in EDGE_OFFSETS)]


def _sixframe_edge_input(case, K, device):
    """(bytes, bounds) of one edge case; the strands clipped differently
    where the case does not say otherwise."""
    rng = np.random.default_rng(K)
    certain = np.frombuffer(b"ACGTacgtU", np.uint8)
    if case.startswith("length"):
        n = {"3K-1": 3 * K - 1, "3K": 3 * K, "1023": 1023, "1024": 1024, "1025": 1025,
             "2^20-30": (1 << 20) - 30}[case.split()[1]]
        b = certain[rng.integers(0, 9, n)]
        if n > 100:
            b[[n // 3, n - 3 * K - 1]] = ord("N")
        return torch.from_numpy(b).to(device), (0, n, 0, n)
    if case.startswith("offset"):
        # a view of one buffer, unaligned; several tiles and a ragged end
        o = int(case.split()[1])
        buf = torch.from_numpy(_aa_bytes(5 * TILE, K)).to(device)
        n = 4 * TILE - 5
        return buf[o : o + n], (3 * K, n - 7, 1, n // 2)
    if case.startswith("bounds"):
        b = certain[rng.integers(0, 9, 3000)]
        b[1500] = ord("N")
        return torch.from_numpy(b).to(device), (-5, 3100, -1000, 5000)
    L = 2 * TILE + 200
    b = certain[rng.integers(0, 9, L)]
    if case.startswith("flags"):
        edges = (0, 31, 32, 63, 64, 97, TILE - 1, TILE, TILE + 3 * K - 2, 2 * TILE - 1, 2 * TILE,
                 2 * TILE + 3 * K - 2, L - 1)
        b[list(edges)] = np.frombuffer(b"NR!nYx-kmN!Rn", np.uint8)
    else:
        b[20:50] = ord("N")  # across the first code words' boundary
        b[96:128] = ord("n")  # exactly one code word
        b[TILE - 10 : TILE + 40] = ord("N")  # across a tile's edge, in its halo
        b[2 * TILE - 40 : 2 * TILE + 100] = ord("R")
    return torch.from_numpy(b).to(device), (TILE - 5, L - 40, 3, 2 * TILE + 7)


@pytest.mark.parametrize("code", [1, 2])
@pytest.mark.parametrize("case", SIXFRAME_EDGE_CASES)
@pytest.mark.parametrize("K", SIXFRAME_KS)
def test_sixframe_kernels_at_tile_edges(cuda, K, case, code):
    kernel, plain = _sixframe_wrappers(K)
    b, bounds = _sixframe_edge_input(case, K, cuda)
    before = kernel.launches
    got = kernel(b, K, bounds, ncbi_trans_table[code])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _assert_same(got, plain(b.cpu(), K, bounds, ncbi_trans_table[code]))


def _chromosome_cut(bases=2_000_000, seed=23):
    """A cut of the benchmark generator's chromosome: ``chr21.json``'s keys
    at ``bases`` bases, with the large N block cut in proportion."""
    import json

    from kmer_bench.gen import rng_for, synth_chromosome

    traffic = json.loads((ROOT / "kmer_bench" / "traffic" / "chr21.json").read_text())
    traffic.update(bases=bases, big_n_block=traffic["big_n_block"] * bases // traffic["bases"])
    return synth_chromosome(traffic, rng_for(seed, 1))


@pytest.mark.parametrize("K", [7, 12])
def test_sixframe_chromosome_cut_matches_the_reference(cuda, K):
    """The six-frame count on the card at the default chunk, K4 (K = 7) and
    K5 (K = 12), against the plain reference (``reference/sixframe_aa.py``)."""
    seq = _chromosome_cut()
    kmers, counts = sixframe_aa_count(seq, SixFrameCountConfig(K=K), device="cuda")
    want_k, want_c = sixframe_aa.count_table(seq, K)
    assert kmers.dtype == want_k.dtype and kmers.shape == want_k.shape
    assert (np.array_equal(kmers, want_k) if K <= 7 else kmers.tolist() == want_k.tolist())
    assert np.array_equal(counts, want_c) and counts.max() > 1


@pytest.mark.parametrize("K", [1, 7, 8, 15, 32])
def test_sixframe_slice_on_cuda_matches_cpu(cuda, K):
    data = _aa_bytes(300_000, 70 + K)
    cfg = SixFrameCountConfig(K=K, chunk_size=1 << 16)
    kernel, _ = _sixframe_wrappers(K)
    k0, w0 = kernel.launches, rle_unit.launches
    got = sixframe_aa_count(data, cfg, device="cuda")
    n_chunks = len(range(0, data.size - 3 * K + 1, (1 << 16) - (3 * K - 1)))
    assert kernel.launches - k0 == n_chunks and rle_unit.launches - w0 == n_chunks
    want = sixframe_aa_count(data, cfg, device="cpu")
    assert got[0].dtype == want[0].dtype and got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])


def _merge_cases():
    rng = np.random.default_rng(9)
    tile = MERGE_TILE  # outputs a K9 block owns (csrc/merge_path.cuh kMergeTile)

    def table(keys, seed):
        keys = torch.as_tensor(keys, dtype=torch.int64)
        counts = torch.from_numpy(np.random.default_rng(seed).integers(1, 1 << 40, keys.numel()))
        return keys, counts

    def sentinel_tail(keys, n_tail):
        keys = torch.as_tensor(keys, dtype=torch.int64).clone()
        keys[keys.numel() - n_tail :] = SENTINEL
        return keys

    # every key repeated across both tables, so ties straddle every block
    # boundary; counts tell A's rows from B's
    dup_a = torch.repeat_interleave(torch.arange(10), 1000)
    dup_b = torch.repeat_interleave(torch.arange(10), 700)
    uniq_a = torch.sort(torch.from_numpy(rng.integers(0, 1 << 62, 33_333))).values
    uniq_b = torch.sort(torch.from_numpy(rng.integers(0, 1 << 62, 14_001))).values
    # equal keys exactly at the block boundaries
    edge = torch.arange(3 * tile) // 2
    empty = torch.zeros(0, dtype=torch.int64)
    # one key in a run of 2.5 tiles in each table: several tile boundaries,
    # and so several co-ranks, fall inside the run A and B share
    run_a = torch.cat([torch.arange(100), torch.full((5 * tile // 2,), 1000), torch.arange(2000, 2100)])
    run_b = torch.cat([torch.arange(50, 150), torch.full((5 * tile // 2,), 1000), torch.arange(1500, 3000)])
    return {
        "heavy duplication": (table(dup_a, 1), table(dup_b, 2)),
        "ties at block edges": (table(edge[::2], 3), table(edge[1::2], 4)),
        "a empty": (table(empty, 5), table(uniq_b, 6)),
        "b empty": (table(uniq_a, 7), table(empty, 8)),
        "both empty": (table(empty, 9), table(empty, 10)),
        "one row each": (table([5], 11), table([5], 12)),
        "one and many": (table([1 << 40], 13), table(uniq_b, 14)),
        "unequal lengths": (table(uniq_a, 15), table(uniq_b, 16)),
        "sentinel tail a": (table(sentinel_tail(uniq_a, 500), 17), table(uniq_b, 18)),
        "sentinel tail b": (table(uniq_a, 19), table(sentinel_tail(uniq_b, 3), 20)),
        "sentinel tails": (table(sentinel_tail(dup_a, 2500), 21), table(sentinel_tail(uniq_b, 14_001), 22)),
        "odd lengths": (table(uniq_a[: tile + 1], 23), table(uniq_b[: 3 * tile - 1], 24)),
        "a run shared across tiles": (table(run_a, 25), table(run_b, 26)),
        "every key of a below b": (table(uniq_a - (1 << 62), 27), table(uniq_b, 28)),
        "every key of b below a": (table(uniq_a, 29), table(uniq_b - (1 << 62), 30)),
        "single row and empty": (table([-3], 31), table(empty, 32)),
        "tile minus one and plus one": (table(uniq_a[: tile - 1], 33), table(uniq_b[: tile + 1], 34)),
        "one tile in all": (table(uniq_a[:1000], 35), table(uniq_b[: tile - 1000], 36)),
    }


MERGE_CASES = list(_merge_cases())


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_kernel_matches_plain(cuda, name):
    (ka, ca), (kb, cb) = _merge_cases()[name]
    before = merge_tables.launches
    got = merge_tables(ka.to(cuda), ca.to(cuda), kb.to(cuda), cb.to(cuda))
    torch.cuda.synchronize()
    assert merge_tables.launches == before + (1 if ka.numel() + kb.numel() else 0)
    _assert_same(got, merge_tables_plain(ka, ca, kb, cb))


@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (1, 3)])
def test_merge_kernel_on_unaligned_views(cuda, offsets):
    # tables that start 8 bytes past a 16-byte boundary: the staging loads
    # read a head row alone
    (ka, ca), (kb, cb) = _merge_cases()["unequal lengths"]
    oa, ob = offsets
    args = [x.to(cuda)[o:] for x, o in ((ka, oa), (ca, oa), (kb, ob), (cb, ob))]
    got = merge_tables(*args)
    torch.cuda.synchronize()
    _assert_same(got, merge_tables_plain(ka[oa:], ca[oa:], kb[ob:], cb[ob:]))


def _reduce_cases():
    """K9's cases, and what only a sum can get wrong: zero counts, totals
    near 2^63, a pair across a tile edge, tables that share every key."""
    tile = MERGE_TILE
    cases = _merge_cases()
    (ka, ca), (kb, cb) = cases["unequal lengths"]
    rng = np.random.default_rng(24)
    near = torch.from_numpy((1 << 62) - rng.integers(1, 1 << 20, ka.numel()))
    zeros = torch.from_numpy(rng.integers(0, 3, ka.numel()))
    cases.update({
        "identical": ((ka, ca), (ka, ca)),
        "disjoint": ((ka[:20_000] // 2 * 2, ca[:20_000]), (ka[:14_000] // 2 * 2 + 1, cb[:14_000])),
        "zero counts": ((ka, zeros), (ka[::3], zeros[::3])),
        "counts near 2^62": ((ka, near), (ka[1::2], near[1::2])),
        "an equal pair across a tile edge": (
            (torch.arange(tile), ca[:tile]), (torch.arange(tile - 1, tile + 50), cb[:51])),
    })
    return cases


REDUCE_CASES = list(_reduce_cases())


@pytest.mark.parametrize("name", REDUCE_CASES)
def test_merge_reduce_kernel_matches_plain(cuda, name):
    from torch.profiler import ProfilerActivity, profile

    from kmers_tpu_torch.utils.profiling import counters, reset_counters

    (ka, ca), (kb, cb) = _reduce_cases()[name]
    n = ka.numel() + kb.numel()
    before = merge_reduce_tables.launches
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = merge_reduce_tables(ka.to(cuda), ca.to(cuda), kb.to(cuda), cb.to(cuda))
    torch.cuda.synchronize()
    assert counters() == {"merge_rows": n, "merge_reduce_rows": n}
    reset_counters()
    assert merge_reduce_tables.launches == before + (1 if n else 0)
    _assert_same(got, merge_reduce_tables_plain(ka, ca, kb, cb))


@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (1, 3)])
def test_merge_reduce_kernel_on_unaligned_views(cuda, offsets):
    (ka, ca), (kb, cb) = _reduce_cases()["zero counts"]
    oa, ob = offsets
    args = [x.to(cuda)[o:] for x, o in ((ka, oa), (ca, oa), (kb, ob), (cb, ob))]
    got = merge_reduce_tables(*args)
    torch.cuda.synchronize()
    _assert_same(got, merge_reduce_tables_plain(ka[oa:], ca[oa:], kb[ob:], cb[ob:]))


def test_merge_reduce_kernel_at_chromosome_scale_in_two_launches(cuda):
    # the K = 31 chromosome fold's last merge: ~33 M + ~14 M distinct rows,
    # a fifth of B's keys also in A
    gen = torch.Generator(device=cuda).manual_seed(24)
    ka = torch.sort(torch.randint(0, 1 << 62, (33_000_000,), device=cuda, generator=gen)).values
    kb = torch.cat([ka[::12], torch.randint(0, 1 << 62, (11_250_000,), device=cuda, generator=gen)])
    kb = torch.sort(kb).values
    ca = torch.randint(1, 1 << 20, ka.shape, device=cuda, generator=gen)
    cb = torch.randint(1, 1 << 20, kb.shape, device=cuda, generator=gen)
    from torch.profiler import ProfilerActivity, profile

    merge_reduce_tables(ka, ca, kb, cb)  # warm: the library is loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = merge_reduce_tables(ka, ca, kb, cb)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # K9's partition and the merge-reduce, nothing else on the card
    assert 0 < len(device_ops) <= 4 and sum("k9_" in name for name in device_ops) == 2, device_ops
    want = merge_reduce_tables_plain(ka, ca, kb, cb)  # torch ops on the card
    _assert_same(got, want)
    assert int(got[2]) == int(torch.unique(torch.cat([ka, kb])).numel())


def test_merge_tile_matches_the_source(cuda):
    from kmers_tpu_torch.ops.kernels import _build

    fn = _build.library().k9_merge_tile
    fn.restype = ctypes.c_int
    assert fn() == MERGE_TILE


@functools.cache
def _word_merge_cases(W):
    """Pairs of lexicographically sorted ``(W, n)`` word tables with counts
    (duplicates allowed, as the merge takes them), for K9's word instance."""
    rng = np.random.default_rng(40 + W)
    tile = 4096  # more than the word tile at any W

    def cols(n, top=4):
        # word 0 takes `top` values, so most comparisons go past word 0
        c = rng.integers(0, 1 << 62, (n, W))
        c[:, 0] = rng.integers(0, top, n)
        return c

    def table(c, n_tail=0):
        c = torch.from_numpy(np.asarray(c, dtype=np.int64).reshape(-1, W))
        c = c[torch.from_numpy(np.lexsort(c.numpy().T[::-1].copy()))] if len(c) else c
        if n_tail:
            c = torch.cat([c, torch.full((n_tail, W), SENTINEL)])
        counts = torch.from_numpy(rng.integers(1, 1 << 40, len(c)))
        if n_tail:
            counts[-n_tail:] = 0
        return c.T.contiguous(), counts

    shared = cols(20_000)
    run = np.tile(cols(1), (5 * tile // 2, 1))  # one column over 2.5 tiles
    last_word = cols(30_000)
    last_word[:, : W - 1] = 7  # ties in every word but the last
    empty = np.zeros((0, W), np.int64)
    return {
        "equal columns split across a and b": (table(np.concatenate([shared, cols(9_000)])),
                                               table(np.concatenate([shared, cols(4_001)]))),
        "heavy duplication": (table(cols(10_000, top=1) % 5), table(cols(7_000, top=1) % 5)),
        "sentinel tails": (table(cols(33_333), 500), table(cols(14_001), 3)),
        "a empty": (table(empty), table(cols(14_001))),
        "b empty": (table(cols(33_333)), table(empty)),
        "both empty": (table(empty), table(empty)),
        "one row each": (table(shared[:1]), table(shared[:1])),
        "unequal lengths": (table(cols(33_333)), table(cols(5))),
        "a run shared across tiles": (table(np.concatenate([cols(100), run, cols(100)])),
                                      table(np.concatenate([cols(1_500), run]))),
        "ties in every word but the last": (table(last_word[::2]), table(last_word[1::2])),
        "many tiles": (table(cols((1 << 20) + 3, top=1 << 20)), table(cols(700_001, top=1 << 20))),
    }


WORD_MERGE_CASES = list(_word_merge_cases(2))


@pytest.mark.parametrize("name", WORD_MERGE_CASES)
@pytest.mark.parametrize("W", MERGE_WORDS)
def test_word_merge_kernel_matches_plain(cuda, W, name):
    (wa, ca), (wb, cb) = _word_merge_cases(W)[name]
    before = merge_tables_mw.launches
    got = merge_tables_mw(wa.to(cuda), ca.to(cuda), wb.to(cuda), cb.to(cuda))
    torch.cuda.synchronize()
    assert merge_tables_mw.launches == before + (1 if ca.numel() + cb.numel() else 0)
    assert got[0].is_contiguous() and got[0].shape == (W, ca.numel() + cb.numel())
    _assert_same(got, merge_tables_mw_plain(wa, ca, wb, cb))


@pytest.mark.parametrize("offsets,extra", [((1, 0), (0, 0)), ((0, 3), (0, 0)), ((1, 3), (5, 2)),
                                           ((0, 0), (37, 1))])
@pytest.mark.parametrize("W", MERGE_WORDS)
def test_word_merge_kernel_on_strided_and_unaligned_views(cuda, W, offsets, extra):
    # starts 8 bytes past a 16-byte boundary, and tables cut to their rows
    # (plane stride past the length, as the level stack hands them on); odd
    # lengths put the output's planes off 16-byte boundaries too
    (wa, ca), (wb, cb) = _word_merge_cases(W)["equal columns split across a and b"]
    views = []
    for (w, c), o, e in zip(((wa, ca), (wb, cb)), offsets, extra):
        full = torch.full((W, w.shape[1] + e), 5, dtype=torch.int64)
        full[:, : w.shape[1]] = w
        views += [full.to(cuda)[:, o : w.shape[1]], c.to(cuda)[o:]]
    got = merge_tables_mw(*views)
    torch.cuda.synchronize()
    _assert_same(got, merge_tables_mw_plain(*(v.cpu() for v in views)))


def test_word_merge_tile_matches_the_source(cuda):
    from kmers_tpu_torch.ops.kernels import _build

    fn = _build.library().k9w_merge_tile
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    tiles = [fn(w) for w in range(8)]
    assert all(tiles[w] > 0 and tiles[w] % 256 == 0 for w in MERGE_WORDS)
    assert all(tiles[w] == 0 for w in range(8) if w not in MERGE_WORDS)


@pytest.mark.parametrize("words", [1, 2, 5])
@pytest.mark.parametrize("n,share", [(0, 0.5), (1, 1.0), (1, 0.0), (2047, 0.5), (2048, 0.9),
                                     (2049, 0.1), (1 << 20, 0.5), ((1 << 20) + 3, 1.0), (300_001, 0.0)])
def test_compact_kernel_matches_plain(cuda, words, n, share):
    rng = np.random.default_rng(n + words)
    shape = (n,) if words == 1 else (words, n)
    keys = torch.from_numpy(rng.integers(0, 1 << 62, shape))
    counts = torch.from_numpy(np.where(rng.random(n) < share, rng.integers(1, 1 << 40, n), 0))
    before = compact_table.launches
    got = compact_table(keys.to(cuda), counts.to(cuda))
    torch.cuda.synchronize()
    assert compact_table.launches == before + (1 if n else 0)
    _assert_same(got, compact_table_plain(keys, counts))


def test_streaming_counter_on_cuda_matches_cpu(cuda):
    out = []
    for dev in ("cuda", "cpu"):
        sc = StreamingCounter(CountConfig(K=25, chunk_size=1 << 14), device=dev)
        for seed in (1, 2, 3):
            seq = _bytes(50_000, seed)
            seq[seq == ord("X")] = ord("T")
            sc.update(seq, np.array([0, 100, 20_000, 20_001, 50_000]))
        sc.update(_bytes(5_000, 4).clip(65, 65))  # one chunk of 'A'
        out.append(sc.finalize())
    assert all(np.array_equal(g, w) for g, w in zip(*out))


def test_merge_counts_device_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(12)
    a = np.unique(rng.integers(0, 1 << 62, 300_000)).astype(np.uint64)
    b = np.unique(np.concatenate([a[::3], rng.integers(0, 1 << 62, 100_000).astype(np.uint64)]))
    ac = rng.integers(1, 1 << 40, a.size)
    bc = rng.integers(1, 1 << 40, b.size)
    before = merge_reduce_tables.launches, compact_table.launches
    got = merge_counts_device(a, ac, b, bc, device="cuda")
    assert (merge_reduce_tables.launches, compact_table.launches) == (before[0] + 1, before[1])
    want = merge_counts_device(a, ac, b, bc, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_bench_on_cuda(cuda):
    from kmers_tpu_torch.pipelines.canonical_count import bench

    before = canonical_windows.launches
    line = bench(L=1 << 20, device="cuda")
    assert canonical_windows.launches - before == 4
    assert line["metric"] == "canonical_31mer_count_bases_per_sec_per_chip" and line["value"] > 0


def _sort_cases():
    rng = np.random.default_rng(13)
    n = 1 << 15
    rand = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64))
    extremes = rand.clone()
    extremes[::97] = torch.iinfo(torch.int64).min
    extremes[5::89] = torch.iinfo(torch.int64).max
    sentinels = rand.clone()
    sentinels[torch.from_numpy(rng.random(n) < 0.3)] = SENTINEL
    return {
        "random": rand,
        "all equal": torch.full((n,), -5, dtype=torch.int64),
        "all sentinel": torch.full((n,), SENTINEL, dtype=torch.int64),
        "sorted": torch.sort(rand).values,
        "reverse sorted": torch.sort(rand, descending=True).values,
        "int64 extremes": extremes,
        "30 % sentinels": sentinels,
        "few distinct": torch.from_numpy(rng.integers(0, 3, n)),
        # runs of one key longer than a tile, across every merge round's
        # boundaries: in order, reversed, and shuffled
        "long duplicate runs": torch.arange(n) // 12_289,
        "long duplicate runs reversed": torch.flip(torch.arange(n) // 12_289, [0]),
        "long duplicate runs shuffled": (torch.arange(n) // 12_289)[torch.from_numpy(rng.permutation(n))],
    }


SORT_CASES = list(_sort_cases())


@pytest.mark.parametrize("name", SORT_CASES)
@pytest.mark.parametrize("tile", [1, 2, 64, 1024, 8192, MAX_TILE])
def test_sort_kernel_matches_plain(cuda, name, tile):
    keys = _sort_cases()[name]
    before = bitonic_sort.launches, bitonic_local_sort.launches
    got = bitonic_sort(keys.to(cuda), tile)
    local = bitonic_local_sort(keys.to(cuda), tile)
    torch.cuda.synchronize()
    assert bitonic_sort.launches - before[0] == 1 and bitonic_local_sort.launches - before[1] == 2
    _assert_same([got], [torch.sort(keys).values])
    _assert_same([got, local], [bitonic_sort_plain(keys, tile), bitonic_local_sort_plain(keys, tile)])


@pytest.mark.parametrize("n", [1, 2, 1024, 8192, 16384, 1 << 21, 1 << 22])
def test_sort_kernel_at_one_tile_and_large_n(cuda, n):
    keys = torch.from_numpy(np.random.default_rng(n).integers(0, 1 << 62, n))
    got = bitonic_sort(keys.to(cuda))
    torch.cuda.synchronize()
    _assert_same([got], [torch.sort(keys).values])
    local = bitonic_local_sort(keys.to(cuda), min(n, 8192))
    _assert_same([local], [bitonic_local_sort_plain(keys, min(n, 8192))])


def test_sort_kernel_duplicates_across_rounds_at_large_n(cuda):
    # 2^22 keys of 300 values in runs of 1 to 40,000: equal keys meet at
    # every round's run boundaries and at its merge-tile boundaries
    rng = np.random.default_rng(21)
    n = 1 << 22
    lengths = rng.integers(1, 40_000, 400)
    keys = torch.from_numpy(np.repeat(rng.integers(-150, 150, 400), lengths)[:n])
    keys = torch.cat([keys, torch.full((n - keys.numel(),), 7, dtype=torch.int64)])
    for order in (keys, torch.flip(keys, [0]), keys[torch.from_numpy(rng.permutation(n))]):
        on_card = order.to(cuda)
        got, local = bitonic_sort(on_card), bitonic_local_sort(on_card, MAX_TILE)
        torch.cuda.synchronize()
        _assert_same([got, local], [torch.sort(order).values, bitonic_local_sort_plain(on_card, MAX_TILE)])


@pytest.mark.parametrize("offset", [1, 3])
def test_sort_kernel_on_unaligned_views(cuda, offset):
    # keys that start 8 bytes past a 16-byte boundary: the tile kernel
    # reads them with 8-byte loads
    keys = torch.from_numpy(np.random.default_rng(offset).integers(-(1 << 62), 1 << 62, (1 << 16) + 8))
    view = keys.to(cuda)[offset : offset + (1 << 16)]
    got, local = bitonic_sort(view), bitonic_local_sort(view, 1024)
    torch.cuda.synchronize()
    want = keys[offset : offset + (1 << 16)]
    _assert_same([got, local], [torch.sort(want).values, bitonic_local_sort_plain(want, 1024)])


def test_sort_kernel_max_tile_matches_the_source(cuda):
    from kmers_tpu_torch.ops.kernels import _build

    fn = _build.library().k11_max_tile
    fn.restype = ctypes.c_int
    assert fn() == MAX_TILE


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("L", [1, 31, 32, 33, 255, 256, 287, 288, 5003, (1 << 20) + 3])
def test_k32_kernel_matches_plain(cuda, canonical, L):
    rng = np.random.default_rng(L)
    codes = torch.from_numpy(rng.integers(0, 4, L).astype(np.uint8))
    good = torch.from_numpy(rng.random(L) > 0.002)
    before = windows_k32.launches
    got = windows_k32(codes.to(cuda), good.to(cuda), canonical)
    torch.cuda.synchronize()
    assert windows_k32.launches == before + 1
    _assert_same(got, windows_k32_plain(codes, good, canonical))


@pytest.mark.parametrize("offset", [1, 7, 99999])
def test_k32_kernel_on_odd_offsets(cuda, offset):
    rng = np.random.default_rng(offset)
    codes = torch.from_numpy(rng.integers(0, 4, 1 << 18).astype(np.uint8)).to(cuda)
    good = torch.from_numpy(rng.random(1 << 18) > 0.01).to(cuda)
    for canonical in (False, True):
        got = windows_k32(codes[offset:], good[offset:], canonical)
        torch.cuda.synchronize()
        _assert_same(got, windows_k32_plain(codes[offset:].cpu(), good[offset:].cpu(), canonical))


def test_cli_checkpoint_commands_on_cuda_match_cpu(cuda, tmp_path, capsys):
    import json

    from kmers_tpu_torch.__main__ import main
    from kmers_tpu_torch.utils import load_count_table

    rng = np.random.default_rng(14)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{''.join('ACGT'[j] for j in rng.integers(0, 4, 3000))}\n" for i in range(6)))
    for k in (21, 40):
        outs = {}
        for dev in ("cuda", "cpu"):
            d = tmp_path / f"{dev}{k}"
            main(["count", str(fa), "-k", str(k), "-o", str(d / "a"), "--device", dev])
            main(["count", str(fa), "-k", str(k), "-o", str(d / "b"), "--device", dev])
            before = merge_reduce_tables.launches, compact_table.launches
            main(["merge", str(d / "a"), str(d / "b"), "-o", str(d / "m"), "--device", dev])
            if dev == "cuda":
                # K <= 31 merges on the device (one K9 merge-reduce); K > 31 on the host
                want = (1, 0) if k <= 31 else (0, 0)
                assert (merge_reduce_tables.launches - before[0], compact_table.launches - before[1]) == want
            main(["verify", str(d / "a")])
            lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
            for line in lines:
                line.pop("output", None)
                line.pop("checkpoint", None)
            outs[dev] = (lines, load_count_table(d / "m"))
        assert outs["cuda"][0] == outs["cpu"][0] and outs["cuda"][0][-1]["ok"]
        got, want = outs["cuda"][1], outs["cpu"][1]
        assert [int(v) for v in got[0]] == [int(v) for v in want[0]] and np.array_equal(got[1], want[1])


# ---------------------------------------------------------------- the parallel plane


def _sharded_input(L, seed):
    # the pool without its invalid byte and with fewer ambiguous ones
    seq = _bytes(L, seed)
    seq[np.isin(seq, np.frombuffer(b"-RYKM", np.uint8))] = ord("G")
    return seq


@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("chunk", [1 << 20, 1 << 17])
def test_sharded_count_on_cuda_matches_cpu(cuda, ranks, chunk):
    from kmers_tpu_torch import parallel as par

    seq = _sharded_input(1_000_003, 21)
    mesh = par.data_mesh(1) if ranks == 1 else par.Mesh(["cuda:0"] * ranks)
    cfg = par.ShardedCountConfig(K=31, chunk_size=chunk)
    before = canonical_windows.launches, rle_unit.launches, merge_reduce_tables.launches
    got = par.sharded_canonical_count(seq, cfg, mesh)
    shard = -(-seq.size // ranks)
    steps = len(range(0, shard, chunk - 30)) if shard > chunk else 1
    assert canonical_windows.launches - before[0] == ranks * steps
    assert rle_unit.launches - before[1] == ranks * steps
    assert merge_reduce_tables.launches - before[2] == ranks * (steps - 1)
    want = canonical_count_bytes(seq, CountConfig(K=31), device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_sharded_multiword_and_minimizers_on_cuda_match_cpu(cuda):
    from kmers_tpu_torch import parallel as par

    mesh = par.Mesh(["cuda:0"] * 4)
    seq = _sharded_input(300_001, 22)
    before = canonical_words.launches
    got = par.sharded_canonical_count_mw(seq, K=47, mesh=mesh)
    assert canonical_words.launches - before == 4
    want = canonical_count_bytes(seq, CountConfig(K=47), device="cpu")
    assert [int(x) for x in got[0]] == [int(x) for x in want[0]] and np.array_equal(got[1], want[1])
    before = windows_general.launches
    got = par.sharded_minimizer_select(seq, K=15, W=10, mesh=mesh, skip_ambiguous=True)
    assert windows_general.launches - before == 4
    want = tex.minimizer_select(seq, K=15, W=10, skip_ambiguous=True, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("K,chunk", [(7, 1 << 20), (7, 1 << 16), (12, 1 << 16)])
def test_sharded_sixframe_on_cuda_matches_cpu(cuda, K, chunk):
    from kmers_tpu_torch import parallel as par

    seq = _bytes(300_001, 24 + K, invalid=True)
    cfg = par.SixFrameCountConfig(K=K, chunk_size=chunk)
    kernel = sixframe_windows if K <= 7 else sixframe_words
    before = kernel.launches, rle_unit.launches
    got = par.sharded_sixframe_aa_count(seq, cfg, par.Mesh(["cuda:0"] * 4))
    # each rank's slab of shard + 6K bytes, in chunks that overlap by 3K - 1
    shard = -(-seq.size // 4)
    shard += (-shard) % 3
    steps = len(range(0, shard + 3 * K + 1, chunk - (3 * K - 1)))
    assert kernel.launches - before[0] == 4 * steps
    assert rle_unit.launches - before[1] == 4 * steps
    want = par.sharded_sixframe_aa_count(seq, cfg, par.data_mesh(4, device="cpu"))
    assert got[0].dtype == want[0].dtype and got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1]) and got[1].sum() > 0


NCCL_SCRIPT = r"""
import json, socket, sys
import numpy as np
import torch.distributed as dist
from kmers_tpu_torch import parallel as par

seq = np.fromfile(sys.argv[1], np.uint8)
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
try:
    mesh = par.data_mesh()
    k, c = par.sharded_canonical_count(seq, par.ShardedCountConfig(K=31, chunk_size=1 << 17), mesh)
    k47, c47 = par.sharded_canonical_count_mw(seq, K=47, mesh=mesh)
    aa, caa = par.sharded_sixframe_aa_count(seq, par.SixFrameCountConfig(K=7, chunk_size=1 << 17), mesh)
    print(json.dumps({"devices": [str(d) for d in mesh.devices], "size": mesh.size,
                      "grouped": mesh.group is not None, "k31": [k.tolist(), c.tolist()],
                      "k47": [[str(int(x)) for x in k47], c47.tolist()], "aa7": [aa.tolist(), caa.tolist()]}))
finally:
    dist.destroy_process_group()
"""


def test_sharded_count_over_nccl_world_size_one(cuda, tmp_path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    seq = _sharded_input(400_009, 23)
    seq.tofile(tmp_path / "seq.bin")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", NCCL_SCRIPT, str(tmp_path / "seq.bin")], cwd=root,
        env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["devices"] == ["cuda:0"] and out["size"] == 1 and out["grouped"]
    want = canonical_count_bytes(seq, CountConfig(K=31), device="cpu")
    assert out["k31"] == [want[0].tolist(), want[1].tolist()]
    want = canonical_count_bytes(seq, CountConfig(K=47), device="cpu")
    assert out["k47"] == [[str(int(x)) for x in want[0]], want[1].tolist()]
    want = sixframe_aa_count(seq, SixFrameCountConfig(K=7), device="cpu")
    assert out["aa7"] == [want[0].tolist(), want[1].tolist()]
