"""Port parity for the hash path, bit-exact against the JAX package:

- ``ops/hashing.py::fx_hash_u64`` and the hash-key conversions of
  ``convert.py`` against ``kmers_tpu.ops.hashing.fx_hash_u64``;
- kernel K1's hash mode, ``canonical_hashes_plain``, against the Pallas
  kernel ``canonical_windows_u32_pallas(..., emit_hash=True)`` in interpret
  mode (as a multiset, since its order is a tile relabelling, with the same
  byte counters), and elementwise against ``canonical_hash_masked_pallas``
  and ``canonical_hash_bytes_pallas`` (the K8c and K8a hash forms, which the
  port covers with K1's hash mode);
- the wrapper on the CPU.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu.ops.hashing import fx_hash_u64 as jax_fx_hash
from kmers_tpu.ops.pallas.window_kernel import (
    canonical_hash_bytes_pallas,
    canonical_hash_masked_pallas,
    canonical_windows_u32_pallas,
    linearize_offset_major,
)
from kmers_tpu_torch.convert import SENTINEL, SIGN_BIT, hashes_from_jax, hashes_to_uint64
from kmers_tpu_torch.ops.hashing import FX_CONSTANT, fx_hash_u64
from kmers_tpu_torch.ops.kernels.window_kernel import (
    canonical_hashes,
    canonical_hashes_plain,
    canonical_windows_plain,
)

POOL = np.frombuffer(b"ACGTNacgtuRYKM-X", dtype=np.uint8)
U64 = 2**64
#: the register whose FxHash is all-ones (the JAX invalid hash)
ALL_ONES_PREIMAGE = (U64 - 1) * pow(FX_CONSTANT, -1, U64) % U64


def _bytes(L, seed, invalid=True, other=0.2):
    """Certain bases in both cases, and a share ``other`` of the rest of
    the pool (ambiguous, '-', 'X' unless ``invalid`` is False)."""
    rng = np.random.default_rng(seed)
    p = np.full(len(POOL), other / (len(POOL) - 8))
    p[[0, 1, 2, 3, 5, 6, 7, 8]] = (1 - other) / 8
    b = POOL[rng.choice(len(POOL), size=L, p=p)]
    if not invalid:
        b[b == ord("X")] = ord("A")
    return b


def _jax_hash(regs_u64: np.ndarray) -> np.ndarray:
    hh, hl = jax_fx_hash(
        (regs_u64 >> np.uint64(32)).astype(np.uint32), (regs_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    )
    return (np.asarray(hh).astype(np.uint64) << np.uint64(32)) | np.asarray(hl).astype(np.uint64)


def _regs(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "62-bit":  # K <= 31 registers, with the extremes
        r = rng.integers(0, 1 << 62, 5000, dtype=np.uint64)
        return np.concatenate([np.array([0, 1, (1 << 62) - 1], np.uint64), r])
    if kind == "64-bit":  # K = 32 registers: every bit pattern
        r = rng.integers(0, U64 - 1, 5000, dtype=np.uint64, endpoint=True)
        return np.concatenate([np.array([U64 - 1, 1 << 63, (1 << 63) - 1], np.uint64), r])
    return np.array([ALL_ONES_PREIMAGE], np.uint64)


@pytest.mark.parametrize("kind", ["62-bit", "64-bit", "all-ones preimage"])
def test_fx_hash_matches_jax(kind):
    regs = _regs(kind)
    want = _jax_hash(regs)
    keys = fx_hash_u64(torch.from_numpy(regs.view(np.int64)))
    assert np.array_equal(hashes_to_uint64(keys), want)
    # the order keys sort as the unsigned hashes do
    assert np.array_equal(np.argsort(keys.numpy(), kind="stable"), np.argsort(want, kind="stable"))
    jkeys = hashes_from_jax((want >> np.uint64(32)).astype(np.uint32), (want & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert torch.equal(jkeys, keys)
    if kind == "all-ones preimage":
        assert want[0] == np.uint64(U64 - 1) and int(keys[0]) == SENTINEL
        assert ALL_ONES_PREIMAGE >= 1 << 62  # no K <= 31 register hashes to it


def test_hash_of_each_register_is_the_python_product():
    regs = _regs("64-bit")[:50]
    got = hashes_to_uint64(fx_hash_u64(torch.from_numpy(regs.view(np.int64))))
    assert [int(g) for g in got] == [int(r) * FX_CONSTANT % U64 for r in regs]
    assert SIGN_BIT == -(1 << 63)


@pytest.mark.parametrize("K", [1, 21, 31])
def test_plain_matches_pallas_emit_hash_multiset(K):
    V, L = 128, 5003
    b = _bytes(L, 11 * K, other=0.01)
    keys, n_invalid, n_ambig = canonical_hashes_plain(torch.from_numpy(b), K)
    pad = (-L) % (4 * V)
    padded = np.concatenate([b, np.full(pad, ord("N"), np.uint8)])
    hh, hl, j_invalid, j_ambig = canonical_windows_u32_pallas(
        padded.view("<u4"), K, V=V, interpret=True, emit_hash=True
    )
    jkeys = hashes_from_jax(np.asarray(hh), np.asarray(hl)).numpy()
    keys = keys.numpy()
    assert (keys != SENTINEL).sum() > L // 20
    assert np.array_equal(np.sort(keys[keys != SENTINEL]), np.sort(jkeys[jkeys != SENTINEL]))
    assert int(n_invalid) == int(j_invalid)
    # the Pallas counters include the 'N' padding, an ambiguous byte
    assert int(n_ambig) == int(j_ambig) - pad


@pytest.mark.parametrize("K", [7, 31])
def test_plain_matches_hash_masked_elementwise(K):
    """K8c's hash form (``tests/test_pallas.py::TestHashKernel``)."""
    b = _bytes(5000, K, invalid=False, other=0.05)
    codes, certain, _ = jax_classify(b)
    hh, hl = canonical_hash_masked_pallas(np.asarray(codes), np.asarray(certain), K, W=128, interpret=True)
    n = b.size - K + 1
    want = hashes_from_jax(linearize_offset_major(hh, n), linearize_offset_major(hl, n))
    keys, _, _ = canonical_hashes_plain(torch.from_numpy(b), K)
    assert torch.equal(keys[:n], want)
    assert (keys[n:] == SENTINEL).all()


@pytest.mark.parametrize("K,L", [(1, 17), (5, 1000), (31, 5003)])
def test_plain_matches_hash_bytes_elementwise(K, L):
    """K8a's hash form (``tests/test_pallas.py::TestFusedBytesKernel``)."""
    b = _bytes(L, L + K, other=0.05)
    hh, hl = canonical_hash_bytes_pallas(b, K, W=128, interpret=True)
    n = L - K + 1
    want = hashes_from_jax(linearize_offset_major(hh, n), linearize_offset_major(hl, n))
    keys, _, _ = canonical_hashes_plain(torch.from_numpy(b), K)
    assert torch.equal(keys[:n], want)


def test_plain_hash_is_the_hash_of_the_register_mode():
    b = torch.from_numpy(_bytes(3000, 5))
    regs, n_invalid, n_ambig = canonical_windows_plain(b, 13)
    keys, h_invalid, h_ambig = canonical_hashes_plain(b, 13)
    valid = regs != SENTINEL
    assert torch.equal(valid, keys != SENTINEL)
    assert torch.equal(keys[valid], fx_hash_u64(regs[valid]))
    assert int(n_invalid) == int(h_invalid) and int(n_ambig) == int(h_ambig)


@pytest.mark.parametrize("K", [0, 32])
def test_k_out_of_range_raises(K):
    b = torch.from_numpy(_bytes(64, 0))
    with pytest.raises(ValueError):
        canonical_hashes_plain(b, K)
    with pytest.raises(ValueError):
        canonical_hashes(b, K)


def test_wrapper_takes_plain_version_on_cpu():
    b = torch.from_numpy(_bytes(300, 3))
    before = canonical_hashes.launches
    got = canonical_hashes(b, 11)
    want = canonical_hashes_plain(b, 11)
    assert canonical_hashes.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        canonical_hashes(torch.zeros(8, dtype=torch.int64), 3)
