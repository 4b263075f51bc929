"""Port parity for multi-word registers (K > 31), bit-exact against the JAX
package on shared state:

- ``kmers_tpu_torch.ops.multiword`` against ``kmers_tpu/ops/multiword.py``
  (windows element by element; ``sort_count_mw``, ``compact_counts`` and
  ``merge_compact_tables_mw`` table by table, through ``words_from_jax``,
  the merge at every width the word merge is built for, with shared
  columns, sentinel tails, empty tables and views cut to their rows);
- kernel K3's plain version, ``canonical_words_plain``, against the Pallas
  ``canonical_windows_mw_pallas`` in interpret mode (whose output order is
  a tile relabelling) as a multiset of non-sentinel registers, with the
  same byte counters;
- the word conversions of ``convert.py``.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_tpu.ops import multiword as jmw
from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu.ops.pallas.multiword_kernel import canonical_windows_mw_pallas
from kmers_tpu.ops.windows import window_valid_mask as jax_valid
from kmers_tpu_torch import convert
from kmers_tpu_torch.convert import SENTINEL, n_words, words_from_jax, words_to_ints, words_to_jax
from kmers_tpu_torch.ops import multiword as tmw
from kmers_tpu_torch.ops.count import compact_counts
from kmers_tpu_torch.ops.encode import classify_2bit
from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words, canonical_words_plain

POOL = np.frombuffer(b"ACGTacgtuNRYK-X", dtype=np.uint8)
WINDOW_KS = [32, 33, 47, 48, 62, 63, 64, 80, 100]


def _bytes(L, seed, junk=0.01):
    """Mostly certain bases (so that long windows survive), a repeated
    unit (so that registers repeat), and a few N/IUPAC/invalid bytes."""
    rng = np.random.default_rng(seed)
    p = np.full(len(POOL), junk / (len(POOL) - 9))
    p[:9] = (1 - p[9:].sum()) / 9
    b = POOL[rng.choice(len(POOL), size=L, p=p)]
    if L >= 400:
        b[L // 2 : L // 2 + 150] = b[:150]
    return b


def _limbs_pool(rng, K, n, pool=40):
    """``n`` JAX registers of 2K bits as M uint32 limbs, drawn from a small
    pool so that they repeat, plus a validity mask."""
    M = -(-2 * K // 32)
    top = 2 * K - 32 * (M - 1)
    regs = [rng.integers(0, 1 << 32, pool, dtype=np.uint64).astype(np.uint32) for _ in range(M)]
    regs[0] &= np.uint32((1 << top) - 1) if top < 32 else np.uint32(0xFFFFFFFF)
    pick = rng.integers(0, pool, n)
    return [r[pick] for r in regs], rng.random(n) < 0.85


def _ints(words):
    """Columns of (W, n) words as a sorted list of Python ints."""
    return sorted(words_to_ints(np.asarray(words)).tolist())


# ---------------------------------------------------------------- windows


@pytest.mark.parametrize("L", [150, 1000])
@pytest.mark.parametrize("K", WINDOW_KS)
def test_windows_match_jax_elementwise(K, L):
    b = _bytes(L, 31 * K + L)
    codes, _, _ = classify_2bit(torch.from_numpy(b))
    jcodes, jcertain, _ = jax_classify(b)
    got = tmw.canonical_windows_mw(codes, K)
    want = words_from_jax(jmw.canonical_windows_mw(jcodes, K), K)
    assert got.shape == (n_words(K), L - K + 1)
    # garbage codes at uncertain bytes are the same on both sides, so every
    # window compares, valid or not
    assert torch.equal(got, want)
    # and the byte-level composition: the valid windows, SENTINEL elsewhere
    words, n_invalid, n_ambig = tmw.canonical_windows_mw_bytes(torch.from_numpy(b), K)
    valid = torch.from_numpy(np.array(jax_valid(jcertain, K)))
    assert words.shape == (n_words(K), L)
    assert torch.equal(words[:, : L - K + 1], torch.where(valid, want, SENTINEL))
    assert (words[:, L - K + 1 :] == SENTINEL).all()


@pytest.mark.parametrize("K", [32, 47, 100])
def test_windows_shorter_than_k(K):
    codes = torch.zeros(K - 1, dtype=torch.int64)
    assert tmw.canonical_windows_mw(codes, K).shape == (n_words(K), 0)
    words, _, _ = tmw.canonical_windows_mw_bytes(torch.from_numpy(_bytes(K - 1, 0)), K)
    assert words.shape == (n_words(K), K - 1) and (words == SENTINEL).all()


@pytest.mark.parametrize("L", [200, 700])
@pytest.mark.parametrize("K", [32, 33, 47, 48, 63])
def test_k3_plain_matches_pallas_multiset(K, L):
    V = 128
    b = _bytes(L, 7 * K + L, junk=0.02)
    words, n_invalid, n_ambig = canonical_words_plain(torch.from_numpy(b), K)
    pad = (-L) % (4 * V)
    padded = np.concatenate([b, np.full(pad, ord("N"), np.uint8)])
    limbs, j_invalid, j_ambig = canonical_windows_mw_pallas(
        padded.view("<u4"), K, V=V, interpret=True
    )
    jwords = words_from_jax(limbs, K)
    real = words[0] != SENTINEL
    jreal = jwords[0] != SENTINEL
    assert int(real.sum()) > 0
    assert _ints(words[:, real]) == _ints(jwords[:, jreal])
    # the Pallas counters include the 'N' padding, an ambiguous byte
    assert int(n_invalid) == int(j_invalid)
    assert int(n_ambig) == int(j_ambig) - pad


def test_k3_wrapper_takes_plain_version_on_cpu():
    b = torch.from_numpy(_bytes(500, 3))
    before = canonical_words.launches
    got = canonical_words(b, 40)
    want = canonical_words_plain(b, 40)
    assert canonical_words.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("K", [31, 64, 0, 101])
def test_k_out_of_range_raises(K):
    b = torch.from_numpy(_bytes(200, 0))
    with pytest.raises(ValueError):
        canonical_words(b, K)
    with pytest.raises(ValueError):
        canonical_words_plain(b, K)
    if not 1 <= K <= 100:
        with pytest.raises(ValueError):
            tmw.canonical_windows_mw_bytes(b, K)
        with pytest.raises(ValueError):
            tmw.canonical_windows_mw(torch.zeros(200, dtype=torch.int64), K)


def test_k3_wrapper_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        canonical_words(torch.zeros(64, dtype=torch.int64), 40)


# ---------------------------------------------------------------- counting


@pytest.mark.parametrize("K", [32, 47, 48, 63, 64, 100])
@pytest.mark.parametrize("n", [1, 300, 2048])
def test_sort_count_mw_matches_jax(rng, K, n):
    limbs, valid = _limbs_pool(rng, K, n)
    ulimbs, jcounts, jn = jmw.sort_count_mw(
        tuple(jnp.asarray(x) for x in limbs), jnp.asarray(valid), key_bits=2 * K
    )
    uniq, counts, n_unique = tmw.sort_count_mw(words_from_jax(limbs, K), torch.from_numpy(valid))
    # the same sorted order, so the tables agree slot by slot
    assert torch.equal(uniq, words_from_jax(ulimbs, K))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts).astype(np.int64))
    assert int(n_unique) == int(jn)


@pytest.mark.parametrize("K", [33, 48, 80])
def test_compact_counts_of_words_matches_jax(rng, K):
    limbs, valid = _limbs_pool(rng, K, 1500)
    ulimbs, jcounts, _ = jmw.sort_count_mw(
        tuple(jnp.asarray(x) for x in limbs), jnp.asarray(valid), key_bits=2 * K
    )
    want_limbs, want_counts = jmw.compact_counts_mw(ulimbs, jcounts)
    uniq, counts, _ = tmw.sort_count_mw(words_from_jax(limbs, K), torch.from_numpy(valid))
    got_words, got_counts = compact_counts(uniq, counts)
    assert torch.equal(got_words, words_from_jax(want_limbs, K))
    assert np.array_equal(got_counts.numpy(), np.asarray(want_counts).astype(np.int64))


@pytest.mark.parametrize("na,nb", [(700, 1300), (1, 64), (512, 512)])
@pytest.mark.parametrize("K", [32, 47, 63, 100])
def test_merge_compact_tables_mw_matches_jax(rng, K, na, nb):
    jtables, ttables = [], []
    for n in (na, nb):
        limbs, valid = _limbs_pool(rng, K, n, pool=3 * n // 4 + 1)
        ulimbs, jcounts, jn = jmw.sort_count_mw(
            tuple(jnp.asarray(x) for x in limbs), jnp.asarray(valid), key_bits=2 * K
        )
        cl, cc = jmw.compact_counts_mw(ulimbs, jcounts)
        jtables.append((cl, cc))
        # the port's table is the JAX one's real rows, handed over
        real = np.asarray(cc) > 0
        ttables.append((words_from_jax(cl, K)[:, real], torch.from_numpy(np.asarray(cc)[real].astype(np.int64))))
    (al, ac), (bl, bc) = jtables
    wl, wc, wn = jmw.merge_compact_tables_mw(al, ac, bl, bc)
    gw, gc, gn = tmw.merge_compact_tables_mw(*ttables[0], *ttables[1])
    nu = int(gn)
    assert nu == int(wn)
    assert torch.equal(gw[:, :nu], words_from_jax(wl, K)[:, :nu])
    assert np.array_equal(gc[:nu].numpy(), np.asarray(wc)[:nu].astype(np.int64))
    assert (gw[:, nu:] == SENTINEL).all() and (gc[nu:] == 0).all()


def _split_tables(rng, K, bps, na, nb, shared, tail_a, tail_b):
    """Two lexicographically sorted tables of distinct ``bps K``-bit
    registers, ``shared`` of them in both, each followed by a sentinel
    tail, as JAX limbs with counts; the port's words from the same limbs."""
    M = -(-bps * K // 32)
    # word 0 takes four values, so most comparisons go on to word 1; the
    # top bits stay clear, so no register is the all-ones sentinel
    low = 62 * (n_words(K, bps) - 1)
    pool = set()
    while len(pool) < na + nb - shared:
        pool.add(int(rng.integers(0, 4)) << low | int.from_bytes(rng.bytes(40), "big") % (1 << low))
    pool = list(pool)
    common, rest = pool[:shared], pool[shared:]
    tables = []
    for n, own, tail in ((na, rest[: na - shared], tail_a), (nb, rest[na - shared :], tail_b)):
        regs = sorted(set(common[: min(shared, n)]) | set(own))
        limbs = [np.array([(r >> (32 * (M - 1 - m))) & 0xFFFFFFFF for r in regs] + [0xFFFFFFFF] * tail,
                          dtype=np.uint32) for m in range(M)]
        counts = np.concatenate([rng.integers(1, 1000, len(regs)), np.zeros(tail, np.int64)])
        tables.append((limbs, counts))
    return tables


#: (K, bits a symbol): W = 2, 3, 4 words of nucleotides and the widest
#: six-frame register, 5 words at K = 32
WORD_WIDTHS = [(55, 2), (80, 2), (100, 2), (32, 8)]
#: (na, nb, shared, sentinel tail of a, of b, plane stride past the table)
SPLIT_CASES = {
    "equal columns split across a and b": (300, 200, 150, 0, 0, 0),
    "sentinel tails": (300, 200, 50, 40, 7, 0),
    "a empty": (0, 250, 0, 0, 0, 0),
    "b empty": (250, 0, 0, 0, 0, 0),
    "unequal lengths": (1000, 3, 2, 0, 0, 0),
    "cut to the live rows": (300, 200, 120, 0, 0, 37),
}


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("K,bps", WORD_WIDTHS)
def test_merge_compact_tables_mw_split_tables_match_jax(rng, K, bps, case):
    na, nb, shared, tail_a, tail_b, extra = SPLIT_CASES[case]
    (al, ac), (bl, bc) = _split_tables(rng, K, bps, na, nb, shared, tail_a, tail_b)
    wl, wc, wn = jmw.merge_compact_tables_mw(
        tuple(map(jnp.asarray, al)), jnp.asarray(ac), tuple(map(jnp.asarray, bl)), jnp.asarray(bc))
    port = []
    for limbs, counts in ((al, ac), (bl, bc)):
        words = words_from_jax(limbs, K, bps=bps)
        if extra:
            # a view cut to its rows, as the level stack hands it on: the
            # plane stride is the uncut length
            full = torch.full((words.shape[0], words.shape[1] + extra), 7, dtype=torch.int64)
            full[:, : words.shape[1]] = words
            words = full[:, : words.shape[1]]
            assert words.stride(0) != words.shape[1]
        port += [words, torch.from_numpy(counts)]
    gw, gc, gn = tmw.merge_compact_tables_mw(*port)
    nu = int(gn)
    assert gw.shape == (n_words(K, bps), port[1].numel() + port[3].numel())
    assert nu == int(wn) == len({tuple(c) for c in gw[:, :nu].T.tolist()})
    assert torch.equal(gw[:, :nu], words_from_jax(wl, K, bps=bps)[:, :nu])
    assert np.array_equal(gc[:nu].numpy(), np.asarray(wc)[:nu].astype(np.int64))
    assert (gw[:, nu:] == SENTINEL).all() and (gc[nu:] == 0).all()


def test_merge_of_port_tables_sums_counts():
    # padding rows (SENTINEL/0) in either input are dropped
    a = torch.tensor([[1, 2, SENTINEL], [5, 0, SENTINEL]])
    b = torch.tensor([[1, 3], [5, 9]])
    words, counts, n = tmw.merge_compact_tables_mw(
        a, torch.tensor([2, 1, 0]), b, torch.tensor([4, 7])
    )
    assert int(n) == 3
    assert words[:, :3].tolist() == [[1, 2, 3], [5, 0, 9]]
    assert counts[:3].tolist() == [6, 1, 7]


# ---------------------------------------------------------------- conversions


@pytest.mark.parametrize("K", [1, 31, 32, 47, 48, 62, 63, 64, 80, 96, 100])
def test_words_round_trip_with_jax_limbs(rng, K):
    limbs, valid = _limbs_pool(rng, K, 500)
    limbs = [np.where(valid, x, np.uint32(0xFFFFFFFF)) for x in limbs]
    words = words_from_jax(limbs, K)
    assert words.shape == (n_words(K), 500)
    assert ((words[:, ~torch.from_numpy(valid)]) == SENTINEL).all()
    real = words[:, torch.from_numpy(valid)]
    assert (real >= 0).all() and (real < (1 << 62)).all()
    back = words_to_jax(words, K)
    for x, y in zip(back, limbs):
        assert np.array_equal(x, y)
    # the public object array is the JAX package's mw_to_numpy
    got = words_to_ints(real.numpy())
    want = jmw.mw_to_numpy(tuple(x[valid] for x in limbs))
    assert got.dtype == object and got.tolist() == want.tolist()


def test_word_layout():
    # K = 63: word 0 holds the first base, the others 31 bases each
    assert [n_words(k) for k in (1, 31, 32, 62, 63, 93, 94, 100)] == [1, 1, 2, 2, 3, 3, 4, 4]
    value = (3 << 124) | (1 << 62) | 5
    limbs = [np.array([(value >> (32 * (3 - m))) & 0xFFFFFFFF], np.uint32) for m in range(4)]
    assert words_from_jax(limbs, 63)[:, 0].tolist() == [3, 1, 5]
    assert words_to_ints(np.array([[3], [1], [5]])).tolist() == [value]


def test_words_wider_than_2k_bits_raise():
    limbs = [np.array([1 << 30], np.uint32), np.array([0], np.uint32), np.array([0], np.uint32)]
    with pytest.raises(ValueError):
        convert.words_from_jax(limbs, 47)  # 94 bits: the top limb holds 30
    with pytest.raises(ValueError):
        convert.words_from_jax(limbs[:2], 47)  # 47 takes 3 limbs
