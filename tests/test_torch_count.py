"""Port parity for ``kmers_tpu_torch.ops.count`` against the JAX package's
``ops/count.py``, bit-exact at the table level (rows with counts > 0), and
for the level-stack fold of chunk tables that the streamed driver runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_tpu.ops import count as jc
from kmers_tpu.utils.levelstack import LevelStack as JaxLevelStack
from kmers_tpu_torch.convert import SENTINEL, keys_from_jax, keys_to_jax, table_from_jax
from kmers_tpu_torch.ops import count as tc
from kmers_tpu_torch.utils.levelstack import LevelStack


def _limbs(rng, n, top_bits=30):
    """uint32 (hi, lo) registers of at most 62 bits, with duplicates, keys
    near 2^62 (signed order must still hold) and a few invalid windows."""
    hi = rng.integers(0, 6, n).astype(np.uint32)
    lo = rng.integers(0, 8, n).astype(np.uint32)
    big = rng.random(n) < 0.2
    hi[big] = (1 << top_bits) - 1 - rng.integers(0, 3, big.sum()).astype(np.uint32)
    valid = rng.random(n) < 0.9
    return hi, lo, valid


def _jax_table(out):
    """(keys, counts) numpy rows of a JAX table with counts > 0."""
    uh, ul, cnt = (np.asarray(x) for x in out[:3])
    keys, counts = table_from_jax(uh, ul, cnt)
    return keys.numpy(), counts.numpy()


def _port_table(keys, counts):
    keep = counts > 0
    return keys[keep].numpy(), counts[keep].numpy()


@pytest.mark.parametrize("n", [1, 257, 4096])
def test_sort_count_matches_jax(rng, n):
    hi, lo, valid = _limbs(rng, n)
    want = jc.sort_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), key_bits=62)
    got = tc.sort_count(keys_from_jax(hi, lo), torch.from_numpy(valid), key_bits=62)
    wk, wc = _jax_table(want)
    gk, gc = _port_table(got[0], got[1])
    assert np.array_equal(gk, wk) and np.array_equal(gc, wc)
    assert int(got[2]) == int(want[3])
    # the same sorted order, so the tables agree slot by slot as well
    assert torch.equal(got[0], keys_from_jax(np.asarray(want[0]), np.asarray(want[1])))


def test_sort_count_rejects_wide_keys():
    with pytest.raises(ValueError):
        tc.sort_count(torch.zeros(4, dtype=torch.int64), key_bits=64)


def test_compact_counts_matches_jax(rng):
    hi, lo, valid = _limbs(rng, 3000)
    uh, ul, cnt, _ = jc.sort_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    want = jc.compact_counts(uh, ul, cnt)
    keys, counts = table_from_jax(np.asarray(uh), np.asarray(ul), np.asarray(cnt))
    # the port's own interspersed table of the same keys
    uniq, ucounts, _ = tc.sort_count(keys_from_jax(hi, lo), torch.from_numpy(valid))
    gk, gc = tc.compact_counts(uniq, ucounts)
    assert torch.equal(gk, keys_from_jax(np.asarray(want[0]), np.asarray(want[1])))
    assert np.array_equal(gc.numpy(), np.asarray(want[2]).astype(np.int64))
    assert torch.equal(gk[: keys.shape[0]], keys)


@pytest.mark.parametrize("na,nb", [(700, 1300), (1, 64), (512, 512)])
def test_merge_compact_tables_matches_jax(rng, na, nb):
    tables = []
    for n in (na, nb):
        hi, lo, valid = _limbs(rng, n)
        uh, ul, cnt, _ = jc.sort_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
        # the JAX bitonic merge takes front-packed tables
        tables.append(jc.compact_counts(uh, ul, cnt))
    (ah, al, ac), (bh, bl, bc) = tables
    want = jc.merge_compact_tables(ah, al, ac, bh, bl, bc)
    ka, ca = table_from_jax(*(np.asarray(x) for x in tables[0]))
    kb, cb = table_from_jax(*(np.asarray(x) for x in tables[1]))
    gk, gc, gnu = tc.merge_compact_tables(ka, ca, kb, cb)
    wk, wc = _jax_table(want)
    nu = int(gnu)
    assert nu == int(want[3])
    assert np.array_equal(gk[:nu].numpy(), wk) and np.array_equal(gc[:nu].numpy(), wc)
    assert (gk[nu:] == SENTINEL).all() and (gc[nu:] == 0).all()


def test_merge_of_jax_table_and_port_table(rng):
    """State handed over from JAX merges like JAX's own table."""
    hi, lo, valid = _limbs(rng, 1500)
    uh, ul, cnt, _ = jc.sort_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    hi2, lo2, valid2 = _limbs(rng, 900)
    vh, vl, vc, _ = jc.sort_count(jnp.asarray(hi2), jnp.asarray(lo2), jnp.asarray(valid2))
    want = _jax_table(
        jc.merge_compact_tables(*jc.compact_counts(uh, ul, cnt), *jc.compact_counts(vh, vl, vc))
    )
    ka, ca = table_from_jax(np.asarray(uh), np.asarray(ul), np.asarray(cnt))
    pk, pc, _ = tc.sort_count(keys_from_jax(hi2, lo2), torch.from_numpy(valid2))
    # the merge takes sorted tables: front-pack the interspersed one, as
    # the JAX half does
    pk, pc = tc.compact_counts(pk, pc)
    gk, gc, gnu = tc.merge_compact_tables(ka, ca, pk, pc)
    nu = int(gnu)
    assert np.array_equal(gk[:nu].numpy(), want[0])
    assert np.array_equal(gc[:nu].numpy(), want[1])
    # and back across the boundary
    h, l = keys_to_jax(gk[:nu])
    assert np.array_equal((h.astype(np.uint64) << 32) | l, want[0].astype(np.uint64))


def test_levelstack_fold_of_five_chunks_matches_jax(rng):
    def jmerge(a, b):
        return jc.merge_compact_tables(a[0], a[1], a[2], b[0], b[1], b[2])

    def jslice(out):
        cap = jc._next_pow2(max(int(out[3]), 1))
        return tuple(x[:cap] for x in out[:3])

    def tmerge(a, b):
        return tc.merge_compact_tables(a[0], a[1], b[0], b[1])

    def tslice(out):
        nu = int(out[2])
        return out[0][:nu], out[1][:nu]

    jstack, tstack = JaxLevelStack(jmerge, jslice), LevelStack(tmerge, tslice)
    for n in (800, 1024, 333, 2000, 64):
        hi, lo, valid = _limbs(rng, n)
        uh, ul, cnt, nu = jc.sort_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
        cap = jc._next_pow2(max(int(nu), 1))
        jstack.push(tuple(x[:cap] for x in jc.compact_counts(uh, ul, cnt)))
        keys, counts, tnu = tc.sort_count(keys_from_jax(hi, lo), torch.from_numpy(valid))
        keys, counts = tc.compact_counts(keys, counts)
        tstack.push((keys[: int(tnu)], counts[: int(tnu)]))
    wk, wc = _jax_table(jstack.fold())
    gk, gc = tstack.fold()
    assert np.array_equal(gk.numpy(), wk) and np.array_equal(gc.numpy(), wc)


@pytest.mark.parametrize("weights", [None, "random"])
def test_weighted_rle_matches_jax(rng, weights):
    hi, lo, _ = _limbs(rng, 1000)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    w = rng.integers(0, 5, hi.size).astype(np.int32) if weights else None
    want = jc._run_length_encode(
        jnp.asarray(hi), jnp.asarray(lo), None if w is None else jnp.asarray(w)
    )
    got = tc._run_length_encode(
        keys_from_jax(hi, lo), None if w is None else torch.from_numpy(w)
    )
    assert torch.equal(got[0], keys_from_jax(np.asarray(want[0]), np.asarray(want[1])))
    assert np.array_equal(got[1].numpy(), np.asarray(want[2]).astype(np.int64))
    assert int(got[2]) == int(want[3])
