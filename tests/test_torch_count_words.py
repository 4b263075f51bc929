"""``canonical_count_words``, the packed word tables of 31 < K <= 100,
held against the plain word reference (``reference/kmers_words.py``, plain
torch, nothing of either package) on the CPU at K = 32, 47, 55 and 62, with
chunks small enough that the word fold runs; ``canonical_count_bytes``
boxes the same rows; the errors, the empty shapes and the counters
``mw_sort_rows`` and ``mw_merge_rows``.  The ``cuda`` case holds the card to the CPU."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmers_tpu_torch import CountConfig, canonical_count_bytes, canonical_count_words
from kmers_tpu_torch.convert import words_to_ints
from kmers_tpu_torch.ops import multiword
from kmers_tpu_torch.symbols import EncodeError
from kmers_tpu_torch.utils.profiling import counters, reset_counters

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from reference import kmers_words as ref  # noqa: E402

#: 200 kb in chunks of 2^14 bases: 13 chunks, so the fold merges 12 times
CHUNK = 1 << 14


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


def _as_words(rows: torch.Tensor) -> np.ndarray:
    return rows.numpy().view(np.uint64)


@pytest.mark.parametrize("K", [32, 47, 55, 62])
def test_words_match_the_reference(K):
    seq = _genome(K)
    words, counts = canonical_count_words(seq, CountConfig(K=K, chunk_size=CHUNK), device="cpu")
    rows, want_c = ref.count_table(seq, K)
    assert words.dtype == np.uint64 and words.flags["C_CONTIGUOUS"] and words.shape == (rows.shape[0], 2)
    assert counts.dtype == np.int64 and counts.shape == (rows.shape[0],)
    assert np.array_equal(words, _as_words(rows)) and np.array_equal(counts, want_c.numpy())
    assert counts.max() > 1 and counts.sum() > 190_000


@pytest.mark.parametrize("K", [32, 55])
def test_count_bytes_boxes_the_same_rows(K):
    seq = _genome(100 + K, 50_000)
    cfg = CountConfig(K=K, chunk_size=4_096)
    words, counts = canonical_count_words(seq, cfg, device="cpu")
    kmers, counts_b = canonical_count_bytes(seq, cfg, device="cpu")
    rows, want_c = ref.count_table(seq, K)
    want = [(h << 62) | lo for h, lo in rows.tolist()]
    assert kmers.dtype == object and list(kmers) == want and list(words_to_ints(words.T)) == want
    assert np.array_equal(counts_b, counts) and np.array_equal(counts, want_c.numpy())


@pytest.mark.parametrize("K", [1, 21, 31])
def test_k_of_one_word_is_refused(K):
    with pytest.raises(ValueError, match="canonical_count_bytes"):
        canonical_count_words(b"ACGT" * 20, CountConfig(K=K), device="cpu")


def test_errors_are_those_of_count_bytes():
    seq = _genome(7, 5_000)
    bad = seq.copy()
    bad[2_500] = ord("X")
    for data, cfg in ((bad, CountConfig(K=47, chunk_size=1_000)),
                      (seq, CountConfig(K=47, chunk_size=1_000, skip_ambiguous=False))):
        with pytest.raises(EncodeError):
            canonical_count_words(data, cfg, device="cpu")
        with pytest.raises(EncodeError):
            canonical_count_bytes(data, cfg, device="cpu")


@pytest.mark.parametrize("K,data", [(55, b"ACGT" * 13), (55, b""), (80, b"ACGT"), (55, b"N" * 300)])
def test_no_window_gives_empty_shapes(K, data):
    words, counts = canonical_count_words(data, CountConfig(K=K), device="cpu")
    W = -(-K // 31)
    assert words.shape == (0, W) and words.dtype == np.uint64 and counts.shape == (0,) and counts.dtype == np.int64


def test_beyond_the_reference_the_words_box_into_the_registers():
    seq = _genome(9, 10_000)
    cfg = CountConfig(K=80, chunk_size=2_000)
    words, counts = canonical_count_words(seq, cfg, device="cpu")
    kmers, counts_b = canonical_count_bytes(seq, cfg, device="cpu")
    assert words.shape[1] == 3 and np.array_equal(counts, counts_b)
    assert list(words_to_ints(words.T)) == list(kmers) == sorted(kmers)


def test_sort_rows_grow_only_under_a_profiler(monkeypatch):
    seq = _genome(11, 20_000)
    cfg = CountConfig(K=55, chunk_size=4_096)
    seen, merged = [], []
    lex_order = multiword._lex_order
    merge = multiword.merge_tables_mw
    monkeypatch.setattr(multiword, "_lex_order", lambda w: seen.append(w.shape[1]) or lex_order(w))
    monkeypatch.setattr(multiword, "merge_tables_mw",
                        lambda wa, ca, wb, cb: merged.append(wa.shape[1] + wb.shape[1]) or merge(wa, ca, wb, cb))
    reset_counters()
    canonical_count_words(seq, cfg, device="cpu")
    assert counters() == {} and seen and merged
    seen.clear()
    merged.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        canonical_count_words(seq, cfg, device="cpu")
    got = counters()
    # every chunk's columns are sorted once; the 4 merges of 5 chunks sort
    # nothing and count the rows they merge
    assert got["mw_sort_rows"] == sum(seen) and len(seen) == 5 and sum(seen) < seq.size + 5 * 55
    assert got["mw_merge_rows"] == sum(merged) and len(merged) == 4
    reset_counters()


@pytest.mark.parametrize("K", [40, 80])
def test_a_word_fold_sorts_each_row_once(monkeypatch, K):
    seq = _genome(K, 30_000)
    chunk = 4_096
    merged = []
    merge = multiword.merge_tables_mw
    monkeypatch.setattr(multiword, "merge_tables_mw",
                        lambda wa, ca, wb, cb: merged.append(wa.shape[1] + wb.shape[1]) or merge(wa, ca, wb, cb))
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        words, counts = canonical_count_words(seq, CountConfig(K=K, chunk_size=chunk), device="cpu")
    got = counters()
    reset_counters()
    # consecutive chunks share K - 1 bases; each chunk's columns are sorted
    # once, and the level stack merges the chunk tables one fewer times
    lengths = [min(chunk, seq.size - s) for s in range(0, seq.size - K + 1, chunk - (K - 1))]
    assert got["mw_sort_rows"] == sum(lengths)
    assert len(merged) == len(lengths) - 1 and got["mw_merge_rows"] == sum(merged)
    # the last merge takes the two top tables, whose rows hold every row once
    assert merged[-1] >= words.shape[0]
    if K <= ref.K_MAX:
        rows, want = ref.count_table(seq, K)
        want_w, want_c = _as_words(rows), want.numpy()
    else:  # beyond the reference: one chunk, no fold
        want_w, want_c = canonical_count_words(seq, CountConfig(K=K, chunk_size=1 << 16), device="cpu")
    assert np.array_equal(words, want_w) and np.array_equal(counts, want_c)


@pytest.fixture
def cuda_device():
    # decided inside the fixture, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 55, 63])
def test_the_card_equals_the_cpu(cuda_device, K):
    seq = np.concatenate([_genome(K, 1_000_000), _genome(K + 1, 1_000_000)])
    cfg = CountConfig(K=K)
    got_w, got_c = canonical_count_words(seq, cfg, device=cuda_device)
    want_w, want_c = canonical_count_words(seq, cfg, device="cpu")
    assert got_w.flags["C_CONTIGUOUS"] and np.array_equal(got_w, want_w) and np.array_equal(got_c, want_c)
    if K <= ref.K_MAX:
        rows, counts = ref.count_table(seq, K)
        assert np.array_equal(got_w, _as_words(rows)) and np.array_equal(got_c, counts.numpy())


@pytest.mark.cuda
def test_a_chromosome_at_k55_folds_by_the_word_merge_on_the_card(cuda_device):
    from kmers_tpu_torch.ops.kernels.merge_kernel import merge_tables_mw

    seq = np.concatenate([_genome(55 + s, 1_000_000) for s in range(4)])
    cfg = CountConfig(K=55)
    chunks = len(range(0, seq.size - 54, cfg.resolved_chunk_size - 54))
    before = merge_tables_mw.launches
    words, counts = canonical_count_words(seq, cfg, device=cuda_device)
    # every merge of the fold launched the word merge; nothing fell back
    assert chunks > 4 and merge_tables_mw.launches - before == chunks - 1
    rows, want = ref.count_table(seq, 55)
    assert np.array_equal(words, _as_words(rows)) and np.array_equal(counts, want.numpy())
