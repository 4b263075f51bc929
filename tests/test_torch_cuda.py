"""The port's CUDA kernels against their plain versions, bit-exact, on the
card.  Every test carries the ``cuda`` marker and skips without a CUDA
device; run them on a GPU host with ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import collections

import numpy as np
import pytest
import torch

from kmers_tpu_torch.convert import SENTINEL
from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words, canonical_words_plain
from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain
from kmers_tpu_torch.ops.kernels.window_kernel import (
    canonical_windows,
    canonical_windows_plain,
)
from kmers_tpu_torch.pipelines.canonical_count import CountConfig, canonical_count_bytes

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
    got = canonical_count_bytes(data, cfg, device="cuda")
    assert canonical_windows.launches - k0 == 4 and rle_unit.launches - w0 == 4
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
