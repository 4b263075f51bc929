"""Port parity for ``ops/minimizer.py``, bit-exact against the jnp
functions of ``kmers_tpu.ops.minimizer``: the doubling sliding minimum
with ties (leftmost wins), minimizers with and without a mask (windows
with no valid k-mer give -1), and closed syncmers over repeated s-mer
hashes."""

import numpy as np
import pytest
import torch

from kmers_tpu.ops import minimizer as jmin
from kmers_tpu_torch.convert import hashes_from_jax, hashes_to_uint64
from kmers_tpu_torch.ops import minimizer

WS = [1, 2, 10, 17]


def _split(u64):
    return (u64 >> np.uint64(32)).astype(np.uint32), (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _join(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _hashes(n, seed, distinct=40):
    """u64 hashes drawn from a few distinct values (many ties), some with
    the top bit set, so unsigned order differs from signed."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2**64 - 1, distinct, dtype=np.uint64, endpoint=True)
    values[:3] = [0, 2**63, 2**64 - 1]
    return values[rng.integers(0, distinct, n)]


def _kmers(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 62, n, dtype=np.uint64)


@pytest.mark.parametrize("W", WS)
def test_sliding_min_matches_jnp(W):
    h = _hashes(3000, W)
    mh, ml, mp = jmin.sliding_min_u64(*_split(h), W)
    keys, pos = minimizer.sliding_min_u64(hashes_from_jax(*_split(h)), W)
    assert np.array_equal(hashes_to_uint64(keys), _join(mh, ml))
    assert np.array_equal(pos.numpy(), np.asarray(mp).astype(np.int64))
    assert pos.dtype == torch.int64


@pytest.mark.parametrize("W", WS)
def test_minimizers_match_jnp(W):
    k = _kmers(2500, W)
    # repeated k-mers give equal hashes: ties inside windows
    k[100:400] = k[:300]
    kh, kl, mp = jmin.minimizers(*_split(k), W)
    kmer, pos = minimizer.minimizers(torch.from_numpy(k.view(np.int64)), W)
    assert np.array_equal(kmer.numpy().view(np.uint64), _join(kh, kl))
    assert np.array_equal(pos.numpy(), np.asarray(mp).astype(np.int64))


@pytest.mark.parametrize("W", WS)
def test_minimizers_masked_match_jnp(W):
    rng = np.random.default_rng(W)
    k = _kmers(2500, 7 * W)
    valid = rng.random(k.size) > 0.2
    valid[500:560] = False  # longer than every W: windows with no valid k-mer
    kh, kl, mp = jmin.minimizers_masked(*_split(k), valid, W)
    kmer, pos = minimizer.minimizers_masked(torch.from_numpy(k.view(np.int64)), torch.from_numpy(valid), W)
    mp = np.asarray(mp).astype(np.int64)
    assert (mp == -1).any()
    assert np.array_equal(pos.numpy(), mp)
    assert np.array_equal(kmer.numpy().view(np.uint64), _join(kh, kl))


@pytest.mark.parametrize("K,s", [(15, 5), (21, 11), (9, 6), (32, 7)])
def test_closed_syncmer_mask_matches_jnp(K, s):
    h = _hashes(4000, K, distinct=300)
    want = np.asarray(jmin.closed_syncmer_mask(*_split(h), K, s))
    got = minimizer.closed_syncmer_mask(hashes_from_jax(*_split(h)), K, s).numpy()
    assert got.shape == want.shape == (h.size - (K - s),)
    assert np.array_equal(got, want) and want.any() and not want.all()


def test_short_streams_and_bad_w():
    keys = torch.arange(5, dtype=torch.int64)
    mk, pos = minimizer.sliding_min_u64(keys, 6)
    assert mk.shape == pos.shape == (0,)
    with pytest.raises(ValueError):
        minimizer.sliding_min_u64(keys, 0)
