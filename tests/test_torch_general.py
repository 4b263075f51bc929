"""Port parity for kernel K6's plain version, ``windows_general_plain``, and
the window building blocks under it, bit-exact against the JAX package:

- elementwise, after ``linearize_offset_major``, against the Pallas kernel
  ``windows_pallas_general`` in interpret mode on the five cases of
  ``tests/test_pallas.py::TestGeneralKernel``;
- against ``canonical_windows_pallas`` (K8b) and
  ``canonical_windows_masked_pallas`` (K8c's window form), which the port
  covers with K6 at 2 bits;
- ``ops/windows.py`` against the jnp window functions at 2, 4 and 8 bits,
  K = 32 included;
- the K = 32 instance's plain version, ``windows_k32_plain`` (K8b at
  K = 32), against ``canonical_windows_pallas`` in interpret mode and the jnp
  forward windows and validity mask;
- the wrappers on the CPU, and their argument checks.

The kernel itself runs only on a GPU (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from kmers_tpu import AminoAcidAlphabet, DNAAlphabet4
from kmers_tpu.ops import u64 as jax_u64
from kmers_tpu.ops import windows as jax_windows
from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu.ops.encode import encode_table, pack_words
from kmers_tpu.ops.pallas.general_kernel import windows_pallas_general
from kmers_tpu.ops.pallas.window_kernel import (
    canonical_windows_masked_pallas,
    canonical_windows_pallas,
    linearize_offset_major,
)
from kmers_tpu_torch.convert import SENTINEL, keys_from_jax
from kmers_tpu_torch.ops import windows
from kmers_tpu_torch.ops.kernels.general_kernel import (
    windows_general,
    windows_general_plain,
    windows_k32,
    windows_k32_plain,
)


def _codes(bps, L, seed):
    """``(codes uint8, good bool)`` of a random stream at ``bps`` bits:
    classify_2bit at 2 bits (with rare 'N's), the reference's
    ``encode_table`` at 4 (DNA with IUPAC codes) and 8 (amino acids), with
    1 % of the symbols marked bad at random."""
    rng = np.random.default_rng(seed)
    if bps == 2:
        b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)]
        b[rng.random(L) < 0.005] = ord("N")
        codes, good, _ = jax_classify(b)
    else:
        pool, alphabet = (b"ACGTMRN", DNAAlphabet4) if bps == 4 else (b"ARNDCQEGHILKMFPSTWYV", AminoAcidAlphabet)
        b = np.frombuffer(pool, np.uint8)[rng.integers(0, len(pool), L)]
        codes, good = encode_table(b, alphabet)
        good = np.asarray(good) & (rng.random(L) >= 0.01)
    codes, good = np.asarray(codes), np.asarray(good)
    assert codes.max() < 1 << bps
    return codes.astype(np.uint8), good


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "bps,K,canonical", [(2, 31, True), (2, 16, False), (4, 15, True), (4, 9, False), (8, 7, False)]
)
def test_plain_matches_pallas_general(bps, K, canonical):
    L = 3001
    codes, good = _codes(bps, L, 100 * bps + K)
    assert not good.all()
    hi, lo = windows_pallas_general(codes, good, K, bps=bps, canonical=canonical, W=128, interpret=True)
    n = L - K + 1
    want = keys_from_jax(linearize_offset_major(hi, n), linearize_offset_major(lo, n))
    got = windows_general_plain(_t(codes), _t(good), K, bps, canonical)
    assert got.shape == (L,)
    assert (got[:n] != SENTINEL).sum() > n // 50
    assert torch.equal(got[:n], want)
    assert (got[n:] == SENTINEL).all()


def test_plain_matches_k8b_canonical_windows_pallas():
    """K8b: packed 2-bit words, every base good, canonical (K <= 31)."""
    K, L = 31, 4000
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, L).astype(np.uint8)
    words = pack_words(codes.astype(np.uint32), bps=2, pad_words=2)
    hi, lo = canonical_windows_pallas(np.asarray(words), K, W=128, interpret=True)
    n = L - K + 1
    want = keys_from_jax(linearize_offset_major(hi, n), linearize_offset_major(lo, n))
    got = windows_general_plain(_t(codes), torch.ones(L, dtype=torch.bool), K, 2, True)
    assert torch.equal(got[:n], want)


def test_plain_matches_k8c_canonical_windows_masked_pallas():
    """K8c's window form: codes + certain, canonical, sentinel where bad."""
    K, L = 21, 5003
    codes, good = _codes(2, L, 9)
    hi, lo = canonical_windows_masked_pallas(codes, good, K, W=128, interpret=True)
    n = L - K + 1
    want = keys_from_jax(linearize_offset_major(hi, n), linearize_offset_major(lo, n))
    got = windows_general_plain(_t(codes), _t(good), K, 2, True)
    assert torch.equal(got[:n], want)


def _jax_u64(pair):
    return jax_u64.to_numpy(tuple(np.asarray(x) for x in pair))


@pytest.mark.parametrize("bps,K", [(2, 1), (2, 17), (2, 32), (4, 16), (4, 5), (8, 8), (8, 3)])
def test_forward_windows_match_jnp(bps, K):
    codes, _ = _codes(bps, 777, bps * K)
    got = windows.windows_from_codes(_t(codes), K, bps).numpy().view(np.uint64)
    assert np.array_equal(got, _jax_u64(jax_windows.windows_from_codes(codes.astype(np.uint32), K, bps)))


@pytest.mark.parametrize("K", [1, 16, 31, 32])
def test_rc_and_canonical_windows_match_jnp(K):
    codes, _ = _codes(2, 500, K)
    c32 = codes.astype(np.uint32)
    rc = windows.rc_windows_from_codes(_t(codes), K).numpy().view(np.uint64)
    assert np.array_equal(rc, _jax_u64(jax_windows.rc_windows_from_codes(c32, K)))
    can = windows.canonical_windows_from_codes(_t(codes), K).numpy().view(np.uint64)
    assert np.array_equal(can, _jax_u64(jax_windows.canonical_windows_from_codes(c32, K)))


@pytest.mark.parametrize("K", [1, 9, 16])
def test_canonical_4bit_windows_match_jnp(K):
    codes, _ = _codes(4, 600, K)
    got = windows.canonical_windows_4bit_from_codes(_t(codes), K).numpy().view(np.uint64)
    want = _jax_u64(jax_windows.canonical_windows_4bit_from_codes(codes.astype(np.uint32), K))
    assert np.array_equal(got, want)


def test_window_k_limits_raise_as_jnp():
    codes = torch.zeros(40, dtype=torch.uint8)
    with pytest.raises(NotImplementedError):
        windows.windows_from_codes(codes, 33)
    with pytest.raises(NotImplementedError):
        windows.canonical_windows_4bit_from_codes(codes, 17)
    with pytest.raises(ValueError):
        windows.windows_from_codes(codes, 0)


@pytest.mark.parametrize(
    "K,bps,canonical", [(0, 2, False), (32, 2, False), (16, 4, True), (8, 8, False), (3, 8, True), (5, 3, False)]
)
def test_out_of_range_raises(K, bps, canonical):
    codes = torch.zeros(64, dtype=torch.uint8)
    good = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError):
        windows_general_plain(codes, good, K, bps, canonical)
    with pytest.raises(ValueError):
        windows_general(codes, good, K, bps, canonical)


def test_wrapper_takes_plain_version_on_cpu():
    codes, good = _codes(4, 1000, 1)
    before = windows_general.launches
    got = windows_general(_t(codes), _t(good), 13, 4, True)
    assert windows_general.launches == before
    assert torch.equal(got, windows_general_plain(_t(codes), _t(good), 13, 4, True))


def test_wrapper_rejects_wrong_types():
    good = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        windows_general(torch.zeros(8, dtype=torch.int64), good, 3)
    with pytest.raises(TypeError):
        windows_general(torch.zeros(8, dtype=torch.uint8), good[:4], 3)
    with pytest.raises(TypeError):
        windows_general(torch.zeros(8, dtype=torch.uint8), good.to(torch.uint8), 3)


def test_short_and_empty_streams():
    for L in (0, 1, 4):
        codes = torch.zeros(L, dtype=torch.uint8)
        got = windows_general(codes, torch.ones(L, dtype=torch.bool), 5)
        assert got.shape == (L,) and (got == SENTINEL).all()


def _u64_keys(hi, lo):
    """JAX (hi, lo) u32 pairs -> the 64-bit patterns as int64 (no sentinel)."""
    full = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    return torch.from_numpy(full.view(np.int64))


@pytest.mark.parametrize("L", [32, 33, 1000, 4099])
def test_k32_plain_matches_k8b_canonical_windows_pallas(L):
    """K8b at K = 32: the unmasked canonical registers of a packed stream,
    with 'N's (their 2-bit codes still enter the registers)."""
    codes, good = _codes(2, L, L)
    words = pack_words(codes.astype(np.uint32), bps=2, pad_words=2)
    hi, lo = canonical_windows_pallas(np.asarray(words), 32, W=128, interpret=True)
    n = L - 32 + 1
    want = _u64_keys(linearize_offset_major(hi, n), linearize_offset_major(lo, n))
    got, valid = windows_k32_plain(_t(codes), _t(good), canonical=True)
    assert got.shape == valid.shape == (L,)
    assert torch.equal(got[:n], want)
    assert (got[:n] < 0).any() or L < 1000  # top bit set: G or T first, unsigned order
    assert torch.equal(valid[:n], torch.from_numpy(np.asarray(jax_windows.window_valid_mask(good, 32))))
    assert not valid[n:].any() and not got[n:].any()


def test_k32_plain_forward_matches_jnp_windows():
    codes, good = _codes(2, 3001, 32)
    got, valid = windows_k32_plain(_t(codes), _t(good), canonical=False)
    n = 3001 - 31
    want = _jax_u64(jax_windows.windows_from_codes(codes.astype(np.uint32), 32, 2))
    assert np.array_equal(got[:n].numpy().view(np.uint64), want)
    assert torch.equal(valid[:n], torch.from_numpy(np.asarray(jax_windows.window_valid_mask(good, 32))))
    assert 0 < int(valid.sum()) < n


def test_k32_keeps_the_sentinel_valued_kmer():
    # CTTT...T is INT64_MAX, the sentinel of K <= 31: valid by its mask
    codes = torch.tensor([1] + [3] * 31, dtype=torch.uint8)
    for canonical in (False, True):
        got, valid = windows_k32(codes, torch.ones(32, dtype=torch.bool), canonical)
        # its reverse complement is A^31 G, register 2
        assert got[:1].tolist() == [2 if canonical else SENTINEL] and valid.tolist() == [True] + [False] * 31


def test_k32_wrapper_takes_plain_version_on_cpu_and_checks_arguments():
    codes, good = _codes(2, 1000, 2)
    before = windows_k32.launches
    for canonical in (False, True):
        got = windows_k32(_t(codes), _t(good), canonical)
        want = windows_k32_plain(_t(codes), _t(good), canonical)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert windows_k32.launches == before
    with pytest.raises(TypeError):
        windows_k32(torch.zeros(8, dtype=torch.int64), torch.ones(8, dtype=torch.bool))
    with pytest.raises(TypeError):
        windows_k32(torch.zeros(8, dtype=torch.uint8), torch.ones(4, dtype=torch.bool))
    for L in (0, 1, 31):
        got, valid = windows_k32(torch.zeros(L, dtype=torch.uint8), torch.ones(L, dtype=torch.bool))
        assert got.shape == (L,) and not got.any() and not valid.any()
