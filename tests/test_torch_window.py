"""Port parity for kernel K1's plain version, ``canonical_windows_plain``,
and its building blocks, bit-exact against the JAX package:

- elementwise, in natural order, against the jnp
  ``canonical_windows_from_codes`` + ``window_valid_mask``;
- as a multiset of non-sentinel registers against the Pallas kernel
  ``canonical_windows_u32_pallas`` in interpret mode (whose output order
  is a tile relabelling), with the same byte counters.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu.ops.pallas.window_kernel import canonical_windows_u32_pallas
from kmers_tpu.ops.windows import (
    canonical_windows_from_codes as jax_windows,
    window_valid_mask as jax_valid,
)
from kmers_tpu_torch.convert import SENTINEL, keys_from_jax
from kmers_tpu_torch.ops.encode import classify_2bit
from kmers_tpu_torch.ops.kernels.window_kernel import (
    canonical_windows,
    canonical_windows_plain,
)
from kmers_tpu_torch.ops.windows import canonical_windows_from_codes, window_valid_mask

POOL = np.frombuffer(b"ACGTNacgtuRYKM-X", dtype=np.uint8)
KS = [1, 5, 16, 31]
LS = [1, 17, 1000, 5003]


def _bytes(L, seed):
    rng = np.random.default_rng(seed)
    # mostly certain bases, so that long windows survive at K = 31
    p = np.full(len(POOL), 0.2 / (len(POOL) - 8))
    p[[0, 1, 2, 3, 5, 6, 7, 8]] = 0.1
    return POOL[rng.choice(len(POOL), size=L, p=p)]


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("K", KS)
def test_plain_matches_jnp_elementwise(K, L):
    b = _bytes(L, 1000 * K + L)
    keys, n_invalid, n_ambig = canonical_windows_plain(torch.from_numpy(b), K)
    keys = keys.numpy()
    assert keys.shape == (L,)
    codes, certain, ambig = jax_classify(b)
    n = max(L - K + 1, 0)
    want = keys_from_jax(*jax_windows(codes, K)).numpy()
    valid = np.asarray(jax_valid(certain, K))
    assert want.shape == valid.shape == (n,)
    assert np.array_equal(keys[:n], np.where(valid, want, SENTINEL))
    assert (keys[n:] == SENTINEL).all()
    invalid = ~(np.asarray(certain) | np.asarray(ambig))
    assert int(n_invalid) == int(invalid.sum())
    assert int(n_ambig) == int(np.asarray(ambig).sum())


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("K", KS)
def test_plain_matches_pallas_multiset(K, L):
    V = 128
    b = _bytes(L, 7 * K + L)
    keys, n_invalid, n_ambig = canonical_windows_plain(torch.from_numpy(b), K)
    pad = (-L) % (4 * V)
    padded = np.concatenate([b, np.full(pad, ord("N"), np.uint8)])
    hi, lo, j_invalid, j_ambig = canonical_windows_u32_pallas(
        padded.view("<u4"), K, V=V, interpret=True
    )
    jkeys = keys_from_jax(np.asarray(hi), np.asarray(lo)).numpy()
    keys = keys.numpy()
    assert np.array_equal(np.sort(keys[keys != SENTINEL]), np.sort(jkeys[jkeys != SENTINEL]))
    # the Pallas counters include the 'N' padding, an ambiguous byte
    assert int(n_invalid) == int(j_invalid)
    assert int(n_ambig) == int(j_ambig) - pad


@pytest.mark.parametrize("K", [1, 7, 31])
def test_building_blocks_match_jnp(K):
    b = _bytes(777, K)
    codes, certain, _ = classify_2bit(torch.from_numpy(b))
    jcodes, jcertain, _ = jax_classify(b)
    got = canonical_windows_from_codes(codes, K).numpy()
    # garbage codes at uncertain bytes are the same on both sides, so every
    # window compares, valid or not
    assert np.array_equal(got, keys_from_jax(*jax_windows(jcodes, K)).numpy())
    assert np.array_equal(window_valid_mask(certain, K).numpy(), np.asarray(jax_valid(jcertain, K)))


@pytest.mark.parametrize("K", [0, 32])
def test_k_out_of_range_raises(K):
    b = torch.from_numpy(_bytes(64, 0))
    with pytest.raises(ValueError):
        canonical_windows_plain(b, K)
    with pytest.raises(ValueError):
        canonical_windows(b, K)


def test_wrapper_takes_plain_version_on_cpu():
    b = torch.from_numpy(_bytes(300, 3))
    before = canonical_windows.launches
    got = canonical_windows(b, 11)
    want = canonical_windows_plain(b, 11)
    assert canonical_windows.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        canonical_windows(torch.zeros(8, dtype=torch.int64), 3)
