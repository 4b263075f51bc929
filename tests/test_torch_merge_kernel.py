"""The device table fold on the CPU: the plain versions of kernels K9
(``merge_tables``) and K10 (``compact_table``) against the Pallas kernels
``bitonic_merge_tail_pallas`` and ``compact_tail_pallas`` in interpret mode,
the port's ``merge_compact_tables`` against the JAX one (with its fused
Pallas tail in interpret mode, and on its default route), K9's
merge-reduce (``merge_reduce_tables``, the one-word fold) against the
composition it replaces, the JAX fold and a summed dictionary, the plain
version of K9's word instance (``merge_tables_mw``: A first on ties, its
counter, what its wrapper refuses), checked mode's
sorted-input contract, and K1's plain version against K7
(``canonical_windows_bytes_flat_pallas``), the TPU kernel that K1 covers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_tpu.ops import count as jc
from kmers_tpu.ops.pallas.merge_kernel import bitonic_merge_tail_pallas, compact_tail_pallas
from kmers_tpu.ops.pallas.window_kernel import canonical_windows_bytes_flat_pallas
from kmers_tpu_torch.convert import SENTINEL, keys_from_jax, keys_to_jax
from kmers_tpu_torch.ops import count as tc
from kmers_tpu_torch.ops.kernels.merge_kernel import (
    MERGE_TILE,
    MERGE_WORDS,
    compact_table,
    compact_table_plain,
    merge_partitions,
    merge_reduce_tables,
    merge_reduce_tables_plain,
    merge_tables,
    merge_tables_mw,
    merge_tables_mw_plain,
    merge_tables_plain,
)
from kmers_tpu_torch.ops.kernels.window_kernel import canonical_windows_plain
from kmers_tpu_torch.utils import checked

W = 128  # the Pallas kernels' lane width in these tests: a tile is 8 W rows
SENT32 = np.uint32(0xFFFFFFFF)


def _sorted_limbs(rng, n, spread, n_sentinel=0):
    """``n`` ascending (hi, lo) uint32 registers below 2^62 with
    duplicates, the last ``n_sentinel`` of them the JAX sentinel."""
    full = np.sort(rng.integers(0, spread, n).astype(np.uint64) * np.uint64(0x9E3779B1))
    full &= np.uint64((1 << 62) - 1)
    full = np.sort(full)
    hi = (full >> np.uint64(32)).astype(np.uint32)
    lo = full.astype(np.uint32)
    if n_sentinel:
        hi[n - n_sentinel :] = SENT32
        lo[n - n_sentinel :] = SENT32
    return hi, lo


def _summed(keys, counts):
    """{key: summed count} of a table."""
    out = {}
    for k, c in zip(keys.tolist(), counts.tolist()):
        out[k] = out.get(k, 0) + c
    return out


@pytest.mark.parametrize("spread,sent_a,sent_b", [(1 << 40, 0, 0), (40, 0, 0), (3, 17, 0), (60, 5, 200)])
def test_merge_plain_matches_bitonic_tail(rng, spread, sent_a, sent_b):
    # one (8, W) tile holding [A ascending, B descending] is a bitonic
    # sequence; the kernel's strides 4W..1 merge it into sorted order
    half = 4 * W
    ah, al = _sorted_limbs(rng, half, spread, sent_a)
    bh, bl = _sorted_limbs(rng, half, spread, sent_b)
    if spread > 1 << 32:  # distinct keys: any counts
        ac = rng.integers(1, 100, half).astype(np.int32)
        bc = rng.integers(1, 100, half).astype(np.int32)
    else:
        # On a tie the Pallas network copies the low row into both slots
        # (the jnp network of count.py keeps each row's own), so with equal
        # keys the counts are a function of the key
        ac = (al % 97 + 1).astype(np.int32)
        bc = (bl % 97 + 1).astype(np.int32)
    ac[half - sent_a :] = 0
    bc[half - sent_b :] = 0
    oh, ol, oc = bitonic_merge_tail_pallas(
        jnp.asarray(np.concatenate([ah, bh[::-1]])), jnp.asarray(np.concatenate([al, bl[::-1]])),
        jnp.asarray(np.concatenate([ac, bc[::-1]])), W=W, interpret=True,
    )
    want_k = keys_from_jax(np.asarray(oh), np.asarray(ol))
    want_c = torch.from_numpy(np.asarray(oc).astype(np.int64))
    tables = (
        keys_from_jax(ah, al), torch.from_numpy(ac.astype(np.int64)),
        keys_from_jax(bh, bl), torch.from_numpy(bc.astype(np.int64)),
    )
    got_k, got_c = merge_tables_plain(*tables)
    assert torch.equal(got_k, want_k)
    if spread > 1 << 32:
        assert torch.equal(got_c, want_c)
    # the order among equal keys may differ: compare summed counts
    assert _summed(got_k, got_c) == _summed(want_k, want_c)
    # the wrapper on a CPU tensor is the plain version
    assert all(torch.equal(x, y) for x, y in zip(merge_tables(*tables), (got_k, got_c)))


def test_merge_plain_puts_a_first_on_ties():
    ka = torch.tensor([1, 2, 2, 5])
    kb = torch.tensor([2, 3, 5])
    keys, counts = merge_tables_plain(ka, torch.tensor([10, 20, 21, 50]), kb, torch.tensor([200, 30, 500]))
    assert keys.tolist() == [1, 2, 2, 2, 3, 5, 5]
    assert counts.tolist() == [10, 20, 21, 200, 30, 50, 500]


def _jax_compact_tail(uh, ul, cnt):
    """JAX compaction through compact_tail_pallas (interpret mode) and the
    remaining passes of ``compact_counts``' network, replayed as
    ``tests/test_pallas.py`` replays them."""
    n = uh.shape[0]
    real = cnt > 0
    nreal = (~real).astype(np.int32)
    d = np.cumsum(nreal) - nreal
    oh, ol, oc, d2, v2 = compact_tail_pallas(
        jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(cnt, jnp.int32), jnp.asarray(d, jnp.int32),
        jnp.asarray(real.astype(np.int32)), W=W, interpret=True,
    )
    oh, ol, oc = np.asarray(oh), np.asarray(ol), np.asarray(oc)
    d2, v2 = np.asarray(d2), np.asarray(v2).astype(bool)
    k = (8 * W).bit_length() - 1
    while (1 << k) < n:
        s = 1 << k

        def sh(a):
            return np.concatenate([a[s:], np.zeros(s, a.dtype)])

        d_in = sh(d2)
        v_in = sh(v2.astype(np.int8)).astype(bool)
        take = v_in & (((d_in >> k) & 1) == 1)
        stay = v2 & (((d2 >> k) & 1) == 0)
        oh = np.where(take, sh(oh), np.where(stay, oh, 0))
        ol = np.where(take, sh(ol), np.where(stay, ol, 0))
        oc = np.where(take, sh(oc), np.where(stay, oc, 0))
        d2 = np.where(take, d_in, d2)
        v2 = take | stay
        k += 1
    return np.where(v2, oh, SENT32), np.where(v2, ol, SENT32), np.where(v2, oc, 0)


@pytest.mark.parametrize("tiles,top", [(2, 60), (4, 5)])
def test_compact_plain_matches_compact_tail(rng, tiles, top):
    n = tiles * 8 * W
    hi = rng.integers(0, top, n).astype(np.uint32)
    lo = rng.integers(0, 8, n).astype(np.uint32)
    uh, ul, cnt, _ = jc.sort_count(jnp.asarray(hi), jnp.asarray(lo))
    uh, ul, cnt = np.asarray(uh), np.asarray(ul), np.asarray(cnt)
    wh, wl, wc = _jax_compact_tail(uh, ul, cnt)
    got_k, got_c = compact_table_plain(keys_from_jax(uh, ul), torch.from_numpy(cnt.astype(np.int64)))
    assert torch.equal(got_k, keys_from_jax(wh, wl))
    assert np.array_equal(got_c.numpy(), wc.astype(np.int64))
    # and the wrapper on a CPU tensor
    kk, kc = compact_table(keys_from_jax(uh, ul), torch.from_numpy(cnt.astype(np.int64)))
    assert torch.equal(kk, got_k) and torch.equal(kc, got_c)


@pytest.mark.parametrize("W_words", [2, 5])
def test_compact_plain_moves_word_planes_together(rng, W_words):
    n = 3000
    words = torch.from_numpy(rng.integers(0, 1 << 62, (W_words, n)))
    counts = torch.from_numpy(rng.integers(0, 3, n))
    got_w, got_c = compact_table(words, counts)
    real = counts > 0
    m = int(real.sum())
    assert torch.equal(got_w[:, :m], words[:, real]) and torch.equal(got_c[:m], counts[real])
    assert (got_w[:, m:] == SENTINEL).all() and (got_c[m:] == 0).all()


def test_compact_table_checks_its_input():
    with pytest.raises(TypeError):
        compact_table(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        compact_table(torch.zeros(4, dtype=torch.int64), torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError):
        merge_tables(torch.zeros(2, dtype=torch.int64), torch.zeros(3, dtype=torch.int64),
                     torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64))


@pytest.mark.parametrize(
    "n,tiles",
    [(0, 0), (1, 1), (MERGE_TILE - 1, 1), (MERGE_TILE, 1), (MERGE_TILE + 1, 2),
     (1_045_503 + 523_824, 384), (33_000_000 + 14_062_500, 11_490)],
)
def test_merge_partitions_give_one_co_rank_a_tile(n, tiles):
    # K9's scratch: the co-rank of each tile's first output; the last tile
    # may be short, and its end is the table's end
    assert merge_partitions(n) == tiles
    assert (tiles - 1) * MERGE_TILE < n <= tiles * MERGE_TILE or n == tiles == 0


def test_merge_partitions_reject_a_negative_length():
    with pytest.raises(ValueError, match="length"):
        merge_partitions(-1)


@pytest.mark.parametrize("bad", ["dtype", "rank", "devices"])
def test_merge_tables_rejects_what_the_kernel_does_not_take(bad):
    a = [torch.arange(4, dtype=torch.int64), torch.ones(4, dtype=torch.int64)]
    b = [torch.arange(3, dtype=torch.int64), torch.ones(3, dtype=torch.int64)]
    if bad == "dtype":
        b[1] = b[1].to(torch.int32)
        with pytest.raises(TypeError):
            merge_tables(*a, *b)
    elif bad == "rank":
        a = [a[0].view(2, 2), a[1].view(2, 2)]
        with pytest.raises(ValueError):
            merge_tables(*a, *b)
    else:
        with pytest.raises(ValueError):
            merge_tables(*a, b[0].to("meta"), b[1].to("meta"))


@pytest.mark.parametrize("bad", ["dtype", "rank", "length", "devices"])
def test_merge_reduce_tables_rejects_what_the_kernel_does_not_take(bad):
    a = [torch.arange(4, dtype=torch.int64), torch.ones(4, dtype=torch.int64)]
    b = [torch.arange(3, dtype=torch.int64), torch.ones(3, dtype=torch.int64)]
    err = ValueError
    if bad == "dtype":
        b[1], err = b[1].to(torch.int32), TypeError
    elif bad == "rank":
        a = [a[0].view(2, 2), a[1].view(2, 2)]
    elif bad == "length":
        b[1] = torch.ones(2, dtype=torch.int64)
    else:
        b = [b[0].to("meta"), b[1].to("meta")]
    with pytest.raises(err):
        merge_reduce_tables(*a, *b)


def _word_table(words, counts):
    return torch.tensor(words, dtype=torch.int64).T.contiguous(), torch.tensor(counts, dtype=torch.int64)


def test_word_merge_plain_puts_a_first_on_ties():
    # columns tie on word 0 and differ on word 1, or tie on both
    wa, ca = _word_table([[1, 9], [2, 0], [2, 4], [2, 4], [5, 1]], [10, 20, 21, 22, 50])
    wb, cb = _word_table([[1, 8], [2, 4], [2, 5], [5, 1]], [100, 200, 300, 500])
    words, counts = merge_tables_mw_plain(wa, ca, wb, cb)
    assert words.T.tolist() == [[1, 8], [1, 9], [2, 0], [2, 4], [2, 4], [2, 4], [2, 5], [5, 1], [5, 1]]
    assert counts.tolist() == [100, 10, 20, 21, 22, 200, 300, 50, 500]
    # the wrapper on CPU tensors is the plain version, on views cut to their
    # rows too
    wide = torch.cat([wb, torch.full((2, 3), SENTINEL)], 1)
    got = merge_tables_mw(wa, ca, wide[:, :4], cb)
    assert torch.equal(got[0], words) and torch.equal(got[1], counts)


@pytest.mark.parametrize("W", MERGE_WORDS)
def test_word_merge_counts_its_rows_under_a_profiler(W):
    from torch.profiler import ProfilerActivity, profile

    from kmers_tpu_torch.utils.profiling import counters, reset_counters

    a = (torch.arange(3 * W, dtype=torch.int64).view(W, 3), torch.ones(3, dtype=torch.int64))
    b = (torch.arange(5 * W, dtype=torch.int64).view(W, 5), torch.ones(5, dtype=torch.int64))
    reset_counters()
    merge_tables_mw(*a, *b)
    assert counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        merge_tables_mw(*a, *b)
        merge_tables_mw(*b, a[0][:, :0], a[1][:0])
    assert counters() == {"mw_merge_rows": 8 + 5}
    reset_counters()


def test_merge_counts_its_rows_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    from kmers_tpu_torch.utils.profiling import counters, reset_counters

    a = (torch.arange(3, dtype=torch.int64), torch.ones(3, dtype=torch.int64))
    b = (torch.arange(5, dtype=torch.int64), torch.ones(5, dtype=torch.int64))
    reset_counters()
    merge_tables(*a, *b)
    assert counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        merge_tables(*a, *b)
        merge_tables(*b, a[0][:0], a[1][:0])
    assert counters() == {"merge_rows": 8 + 5}
    reset_counters()


@pytest.mark.parametrize("bad", ["dtype", "devices", "width mismatch", "count length", "rank", "one word",
                                 "six words"])
def test_merge_tables_mw_rejects_what_the_kernel_does_not_take(bad):
    a = [torch.arange(8, dtype=torch.int64).view(2, 4), torch.ones(4, dtype=torch.int64)]
    b = [torch.arange(6, dtype=torch.int64).view(2, 3), torch.ones(3, dtype=torch.int64)]
    err = ValueError
    if bad == "dtype":
        b[1], err = b[1].to(torch.int32), TypeError
    elif bad == "devices":
        b = [b[0].to("meta"), b[1].to("meta")]
    elif bad == "width mismatch":
        b[0] = torch.arange(9, dtype=torch.int64).view(3, 3)
    elif bad == "count length":
        b[1] = torch.ones(4, dtype=torch.int64)
    elif bad == "rank":
        a[0] = a[0].view(8)
    else:
        W = 1 if bad == "one word" else max(MERGE_WORDS) + 1
        a[0] = torch.zeros((W, 4), dtype=torch.int64)
        b[0] = torch.zeros((W, 3), dtype=torch.int64)
    with pytest.raises(err):
        merge_tables_mw(*a, *b)


def _jax_front_packed(rng, n, top=5000):
    hi = rng.integers(0, top, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 12, n).astype(np.uint32)
    uh, ul, cnt, _ = jc.sort_count(jnp.asarray(hi), jnp.asarray(lo))
    return jc.compact_counts(uh, ul, cnt)


def _port_table(jax_table):
    uh, ul, cnt = (np.asarray(x) for x in jax_table)
    return keys_from_jax(uh, ul), torch.from_numpy(cnt.astype(np.int64))


def test_merge_compact_tables_matches_jax_fused_tail(rng):
    # 16384 + 16384 rows: 2 * half = 8 * 4096, so the JAX merge runs its
    # fused Pallas tail (in interpret mode) on the whole network
    a = _jax_front_packed(rng, 16384)
    b = _jax_front_packed(rng, 16384)
    want = jc.merge_compact_tables(*a, *b, use_pallas=True, tail_interpret=True)
    got = tc.merge_compact_tables(*_port_table(a), *_port_table(b))
    # the same length (na + nb = 2 * half), so the tables agree slot by slot
    assert torch.equal(got[0], keys_from_jax(np.asarray(want[0]), np.asarray(want[1])))
    assert np.array_equal(got[1].numpy(), np.asarray(want[2]).astype(np.int64))
    assert int(got[2]) == int(want[3])


def _table(rng, n, spread, n_sentinel=0):
    """A front-packed port table of ``n`` rows (sorted distinct keys below
    ``spread``, the last ``n_sentinel`` rows padding) and its JAX twin."""
    if spread <= 1 << 20:
        keys = np.sort(rng.permutation(spread)[:n]).astype(np.int64)
    else:  # n + 16 draws from a wide range: distinct in practice
        keys = np.unique(rng.integers(0, spread, n + 16))[:n].astype(np.int64)
    assert keys.size == n
    counts = rng.integers(1, 9, n).astype(np.int64)
    if n_sentinel:
        keys[n - n_sentinel :] = SENTINEL
        counts[n - n_sentinel :] = 0
    k = torch.from_numpy(keys)
    hi, lo = keys_to_jax(k)
    return (k, torch.from_numpy(counts)), (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(counts, jnp.int32))


@pytest.mark.parametrize(
    "na,nb,spread,sent_a,sent_b",
    [(0, 0, 10, 0, 0), (0, 5, 10, 0, 0), (7, 0, 10, 0, 0), (1, 1, 3, 0, 0), (1, 1, 1, 0, 0),
     (37, 37, 40, 0, 0), (123, 45, 200, 0, 0), (100, 257, 10_000, 3, 0), (64, 64, 100, 10, 30),
     (1000, 999, 1 << 61, 0, 1)],
)
def test_merge_compact_tables_matches_jax_default_route(rng, na, nb, spread, sent_a, sent_b):
    (ka, ca), ja = _table(rng, na, spread, sent_a)
    (kb, cb), jb = _table(rng, nb, spread, sent_b)
    want = jc.merge_compact_tables(*ja, *jb)
    got_k, got_c, got_nu = tc.merge_compact_tables(ka, ca, kb, cb)
    nu = int(got_nu)
    assert nu == int(want[3])
    assert got_k.shape[0] == na + nb
    wh, wl, wc = (np.asarray(x)[:nu] for x in want[:3])
    assert torch.equal(got_k[:nu], keys_from_jax(wh, wl))
    assert np.array_equal(got_c[:nu].numpy(), wc.astype(np.int64))
    assert (got_k[nu:] == SENTINEL).all() and (got_c[nu:] == 0).all()
    # full overlap: the table merged with itself doubles every count
    fk, fc, fnu = tc.merge_compact_tables(ka, ca, ka, ca)
    real = ca > 0
    assert int(fnu) == int(real.sum())
    assert torch.equal(fk[: int(fnu)], ka[real]) and torch.equal(fc[: int(fnu)], 2 * ca[real])


def _reduce_cases():
    """Pairs of sorted port tables for K9's merge-reduce, by name."""
    tile = MERGE_TILE  # outputs a K9 block owns
    rng = np.random.default_rng(24)

    def table(keys, counts=None, seed=0):
        keys = torch.as_tensor(keys, dtype=torch.int64)
        if counts is None:
            counts = np.random.default_rng(seed).integers(1, 9, keys.numel())
        return keys, torch.as_tensor(counts, dtype=torch.int64)

    def sentinel_tail(keys, n_tail):
        keys = torch.as_tensor(keys, dtype=torch.int64).clone()
        keys[keys.numel() - n_tail :] = SENTINEL
        return keys

    wide = torch.from_numpy(np.unique(rng.integers(0, 1 << 61, 3000)))
    evens = torch.arange(0, 4000, 2)
    empty = torch.zeros(0, dtype=torch.int64)
    runs = torch.repeat_interleave(torch.arange(50), 7)
    # 77 in a run of more than a tile of A, continued in B
    long_a = torch.cat([torch.arange(10), torch.full((tile + 300,), 77), torch.arange(100, 110)])
    long_b = torch.cat([torch.full((500,), 77), torch.arange(200, 210)])
    # A's last key of merged tile 0 meets its B twin as tile 1's first row
    edge_a, edge_b = torch.arange(tile), torch.arange(tile - 1, tile + 50)
    near = (1 << 62) - np.random.default_rng(7).integers(1, 1 << 20, 2000)
    zeros_a = np.random.default_rng(8).integers(0, 3, 1000)
    zeros_b = np.random.default_rng(9).integers(0, 3, 700)
    return {
        "disjoint": (table(evens, seed=1), table(evens + 1, seed=2)),
        "overlapping": (table(wide[:2000], seed=3), table(wide[1000:], seed=4)),
        "identical": (table(wide, seed=5), table(wide, seed=5)),
        "duplicates inside one table": (table(runs, seed=6), table(torch.arange(0, 100, 3), seed=7)),
        "a run longer than a tile": (table(long_a, seed=8), table(long_b, seed=9)),
        "an equal pair across a tile edge": (table(edge_a, seed=10), table(edge_b, seed=11)),
        "sentinel tail in a": (table(sentinel_tail(wide[:1500], 40), seed=12), table(wide[700:], seed=13)),
        "sentinel tail in b": (table(wide[:1500], seed=14), table(sentinel_tail(wide[700:], 1), seed=15)),
        "sentinel tails in both": (table(sentinel_tail(runs, 30), seed=16),
                                   table(sentinel_tail(wide[:500], 500), seed=17)),
        "zero counts": (table(wide[:1000], zeros_a), table(wide[300:1000], zeros_b)),
        "empty a": (table(empty), table(wide[:100], seed=18)),
        "empty b": (table(wide[:100], seed=19), table(empty)),
        "both empty": (table(empty), table(empty)),
        "counts near 2^62": (table(wide[:1200], near[:1200]), table(wide[400:1200], near[1200:])),
    }


@pytest.mark.parametrize("name", list(_reduce_cases()))
def test_merge_reduce_matches_the_composition_and_jax(name):
    from torch.profiler import ProfilerActivity, profile

    from kmers_tpu_torch.utils.profiling import counters, reset_counters

    (ka, ca), (kb, cb) = _reduce_cases()[name]
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = merge_reduce_tables(ka, ca, kb, cb)
    # the plain route counts the rows merged, and none as the kernel's
    assert counters() == {"merge_rows": ka.numel() + kb.numel()}
    reset_counters()
    # the composition the kernel replaces: K9's merge, the weighted RLE, K10
    merged = tc._run_length_encode(*merge_tables_plain(ka, ca, kb, cb))
    want = (*compact_table_plain(*merged[:2]), merged[2])
    for out in (got, merge_reduce_tables_plain(ka, ca, kb, cb), tc.merge_compact_tables(ka, ca, kb, cb)):
        assert len(out) == 3 and all(torch.equal(x, y) for x, y in zip(out, want))
    keys, counts, n_unique = got
    n = ka.numel() + kb.numel()
    assert keys.shape == counts.shape == (n,) and n_unique.dim() == 0
    # a summed dictionary: every non-sentinel key is a run; those with a
    # total > 0 are kept, in key order, then sentinel/0
    sums = {k: c for k, c in _summed(torch.cat([ka, kb]), torch.cat([ca, cb])).items() if k != SENTINEL}
    kept = sorted(k for k, c in sums.items() if c > 0)
    assert int(n_unique) == len(sums)
    assert keys[: len(kept)].tolist() == kept and counts[: len(kept)].tolist() == [sums[k] for k in kept]
    assert (keys[len(kept):] == SENTINEL).all() and (counts[len(kept):] == 0).all()
    if n and int(torch.cat([ca, cb]).max()) < 1 << 31:  # the JAX package counts in int32
        ja = (*(jnp.asarray(x) for x in keys_to_jax(ka)), jnp.asarray(ca.numpy().astype(np.int32)))
        jb = (*(jnp.asarray(x) for x in keys_to_jax(kb)), jnp.asarray(cb.numpy().astype(np.int32)))
        wh, wl, wc, wnu = jc.merge_compact_tables(*ja, *jb)
        assert int(wnu) == int(n_unique)
        m = min(n, wc.shape[0])
        assert torch.equal(keys[:m], keys_from_jax(np.asarray(wh)[:m], np.asarray(wl)[:m]))
        assert np.array_equal(counts[:m].numpy(), np.asarray(wc)[:m].astype(np.int64))


def test_checked_mode_rejects_an_unsorted_table(rng):
    keys = torch.from_numpy(rng.integers(0, 50, 500))
    uniq, counts, _ = tc.sort_count(keys)  # sentinel-interspersed: not sorted
    packed = tc.compact_counts(uniq, counts)
    with checked():
        with pytest.raises(ValueError, match="not sorted"):
            tc.merge_compact_tables(*packed, uniq, counts)
        with pytest.raises(ValueError, match="table A"):
            tc.merge_compact_tables(uniq, counts, *packed)
        tc.merge_compact_tables(*packed, *packed)  # sorted inputs pass


POOL = np.frombuffer(b"ACGTacgtuUNRYKM-X", np.uint8)


@pytest.mark.parametrize("K", [1, 5, 31])
@pytest.mark.parametrize("L", [1, 17, 1000, 5003])
def test_k1_plain_matches_k7_multiset_and_counters(K, L):
    rng = np.random.default_rng(L + K)
    p = np.full(len(POOL), 0.01)
    p[:8] = 0.1
    data = POOL[rng.choice(len(POOL), L, p=p / p.sum())]
    hi, lo, n_bad, n_amb = canonical_windows_bytes_flat_pallas(jnp.asarray(data), K, W=W, interpret=True)
    hi, lo = np.asarray(hi), np.asarray(lo)
    real = ~((hi == SENT32) & (lo == SENT32))
    want = np.sort(keys_from_jax(hi[real], lo[real]).numpy())
    keys, n_invalid, n_ambig = canonical_windows_plain(torch.from_numpy(data), K)
    got = np.sort(keys[keys != SENTINEL].numpy())
    assert np.array_equal(got, want)
    assert int(n_invalid) == int(n_bad) and int(n_ambig) == int(n_amb)
