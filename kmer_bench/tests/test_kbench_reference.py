"""The plain reference and the generator, on the CPU: count tables against
a brute-force ``collections.Counter`` of canonical k-mer strings, sketches
against a plain-Python FxHash, the one-base deltas against recounting, the
controls against the reference, and the generator's seeds and sizes."""

import collections

import numpy as np
import pytest

from kmer_bench import gen
from kmer_bench.reference import kmers as ref

CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
MASK64 = (1 << 64) - 1
FX = 0x517CC1B727220A95


def brute_canonical(text: str, k: int) -> list:
    """The canonical k-mer of every valid window, as ints (strings compared:
    A < C < G < T orders them as their 2-bit codes do)."""
    out = []
    for p in range(len(text) - k + 1):
        w = text[p : p + k].upper().replace("U", "T")
        if all(ch in CODE for ch in w):
            rc = "".join(COMP[ch] for ch in reversed(w))
            v = 0
            for ch in min(w, rc):
                v = 4 * v + CODE[ch]
            out.append(v)
    return out


def brute_counts(text: str, k: int):
    c = collections.Counter(brute_canonical(text, k))
    keys = sorted(c)
    return np.array(keys, np.uint64), np.array([c[x] for x in keys], np.int64)


def brute_sketch(text: str, k: int, s: int) -> np.ndarray:
    return np.array(sorted({(v * FX) & MASK64 for v in brute_canonical(text, k)})[:s], np.uint64)


def random_text(seed: int, n: int = 600) -> str:
    """Bases of both cases, U, N runs and IUPAC codes."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ACGTACGTACGTacgtacgtUNRYkmn"))
    chars = alphabet[rng.integers(0, alphabet.size, n)]
    chars[n // 3 : n // 3 + 40] = "N"
    return "".join(chars)


def as_bytes(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), np.uint8).copy()


@pytest.mark.parametrize("k", [1, 2, 5, 16, 21, 31])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_count_table_matches_counter(k, seed):
    text = random_text(seed)
    got = ref.count_table(as_bytes(text), k)
    want = brute_counts(text, k)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_count_table_of_both_strands_is_canonical():
    text = "ACGTTGCAAGGCTTAACG" * 5
    comp = "".join(COMP[c] for c in reversed(text))
    for k in (3, 11, 31):
        a = ref.count_table(as_bytes(text), k)
        b = ref.count_table(as_bytes(comp), k)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("k,s", [(5, 1), (5, 10), (21, 50), (21, 1000), (31, 7)])
@pytest.mark.parametrize("seed", [4, 5])
def test_sketch_matches_plain_fxhash(k, s, seed):
    text = random_text(seed, 900)
    assert np.array_equal(ref.sketch(as_bytes(text), k, s), brute_sketch(text, k, s))


@pytest.mark.parametrize("k", [5, 21, 31])
def test_one_base_delta_equals_recount(k):
    rng = np.random.default_rng(k)
    seq = as_bytes(random_text(k + 10, 800))
    table = ref.count_table(seq, k)
    for pos in [0, 1, k - 1, 399, seq.size - 1, *rng.integers(0, seq.size, 20)]:
        after = seq.copy()
        after[pos] = ord("ACGT"[(int(pos) + 1) % 4])
        minus, plus = ref.window_kmers(seq, pos, k), ref.window_kmers(after, pos, k)
        got = ref.apply_delta(*table, minus, plus)
        want = ref.count_table(after, k)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_apply_delta_rejects_a_missing_kmer():
    with pytest.raises(ValueError):
        ref.apply_delta(np.array([1, 5], np.uint64), np.array([1, 1], np.int64),
                        np.array([3], np.uint64), np.zeros(0, np.uint64))


@pytest.mark.parametrize("k,s", [(5, 20), (21, 30)])
def test_sketch_after_one_base_equals_resketch(k, s):
    rng = np.random.default_rng(s)
    seq = gen.ACGT[rng.integers(0, 4, 3000)]
    head = ref.hash_table(seq, k, head=s + 2 * k + 2)
    for pos in rng.integers(0, seq.size, 30):
        after = seq.copy()
        after[pos] = gen.ACGT[(list(b"ACGT").index(seq[pos]) + 1) % 4]
        got = ref.sketch_after(*head, ref.window_kmers(seq, pos, k), ref.window_kmers(after, pos, k), s)
        assert np.array_equal(got, ref.sketch(after, k, s))


def test_seam_control_counts_each_seam_window_twice():
    rng = np.random.default_rng(9)
    seq = gen.ACGT[rng.integers(0, 4, 5000)]
    k, chunk = 31, 512
    good = ref.count_table(seq, k)
    bad = ref.count_table_seam_double(seq, k, chunk)
    assert np.array_equal(good[0], bad[0])
    n_seams = len(range(chunk - k, seq.size - k + 1, chunk - k))
    assert int(bad[1].sum() - good[1].sum()) == n_seams > 0


def test_hash32_control_differs_everywhere():
    rng = np.random.default_rng(10)
    seq = gen.ACGT[rng.integers(0, 4, 20_000)]
    exact, cut = ref.sketch(seq, 21, 1000), ref.sketch_hash32(seq, 21, 1000)
    assert exact.size == cut.size == 1000
    assert np.intersect1d(exact, cut).size < 10


CHROM = {"bases": 300_000, "repeat_len": 300, "repeat_copies": 40, "repeat_mutation": 0.03,
         "low_complexity": 20_000, "soft_masks": 50, "soft_mask_len": [100, 5000], "n_blocks": 5,
         "n_block_len": [100, 10_000], "big_n_block": 15_000, "iupac_codes": 30, "input": "chromosome"}


def test_chromosome_has_every_kind_of_byte_and_repeats_by_seed():
    a = gen.Inputs(CHROM, 2**31 + 1).items[0]
    b = gen.Inputs(CHROM, 2**31 + 1).items[0]
    c = gen.Inputs(CHROM, 5).items[0]
    assert np.array_equal(a, b) and not np.array_equal(a, c) and a.size == c.size == CHROM["bases"]
    present = set(np.unique(a).tobytes())
    assert set(b"ACGTacgtN") <= present and present & set(b"RYKMSWry")


def test_genome_pool_has_the_same_lengths_for_every_seed():
    t = {"input": "genomes", "lengths": [1000, 2000, 3000]}
    for seed in (0, 7, 2**31 + 3, -5):
        items = gen.Inputs(t, seed).items
        assert sorted(x.size for x in items) == [1000, 2000, 3000]
        assert set(np.unique(np.concatenate(items)).tobytes()) == set(b"ACGT")


def test_reads_fastq_mutation_and_restore(tmp_path):
    t = {"input": "reads", "genome_bases": 5000, "reads": 300, "read_len": 150, "substitution_rate": 0.002}
    inp = gen.Inputs(t, 2**31 + 9, tmp_path)
    text = inp.path.read_bytes().split(b"\n")
    assert len(text) == 4 * 300 + 1 and text[0] == b"@r00000000" and text[2] == b"+"
    assert [np.frombuffer(x, np.uint8).tolist() for x in text[1::4]] == inp.reads.tolist()
    base = inp.sequence(0).copy()
    assert base.size == 300 * 151 - 1 and (base[150::151] == ord("N")).all()
    for i in range(5):
        m = inp.mutate(i)
        now = inp.sequence(0)
        assert now[m.pos] == m.new != m.old == base[m.pos]
        assert int((now != base).sum()) == 1
        lines = inp.path.read_bytes().split(b"\n")
        r, j = divmod(m.pos, 151)
        assert lines[4 * r + 1][j] == m.new
    inp.restore()
    assert np.array_equal(inp.sequence(0), base)
    assert inp.path.read_bytes().split(b"\n")[1::4] == [bytes(x) for x in text[1::4]]
    inp.close()
    assert not inp.path.exists()


def test_join_with_n_keeps_records_apart():
    reads = np.frombuffer(b"ACGTACGT" * 3, np.uint8).reshape(3, 8).copy()
    joined = gen.join_with_n(reads)
    assert joined.tobytes() == b"ACGTACGTNACGTACGTNACGTACGT"
    assert ref.count_table(joined, 8)[1].sum() == 3
