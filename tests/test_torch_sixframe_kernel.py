"""Kernels K4 and K5 (six-frame amino-acid windows) on the CPU: their
plain versions, ``sixframe_windows_plain`` and ``sixframe_words_plain``,
against the Pallas ``sixframe_windows_u32_pallas`` and
``sixframe_windows_mw_u32_pallas`` in interpret mode, as a multiset of
emitted windows with the same ``n_valid`` (the Pallas output order is a
tile relabelling); the plain window functions against the JAX jnp front-end
element by element; and the amino-acid word conversions of
``convert.py``, K5's validity stream included.

The kernels themselves run only on a GPU (tests/test_torch_cuda.py).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_tpu.genetic_codes import standard_genetic_code as jax_standard
from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu.ops.multiword import mw_to_numpy
from kmers_tpu.ops.pallas.sixframe_kernel import (
    sixframe_tbl16,
    sixframe_windows_mw_u32_pallas,
    sixframe_windows_u32_pallas,
)
from kmers_tpu.parallel.sixframe import _strand_windows, _strand_windows_mw
from kmers_tpu_torch.convert import SENTINEL, keys_from_jax, n_words, words_from_jax, words_to_ints, words_to_jax
from kmers_tpu_torch.genetic_codes import ncbi_trans_table
from kmers_tpu_torch.ops.kernels.sixframe_kernel import (
    sixframe_windows,
    sixframe_windows_plain,
    sixframe_words,
    sixframe_words_plain,
)

POOL = np.frombuffer(b"ACGTNacgt!", np.uint8)
V = 256


def _row(rng, K, p3, junk):
    """One two-tile row as ``tests/test_pallas.py`` builds it: ``(row,
    bounds)`` with the strands clipped differently (fw ``[H, H + b)``, rv
    ``[1, b + 1)``) and the last ``p3`` body bytes zeroed."""
    row4 = 4 * V * 2
    H = 3 * K
    B = row4 - 2 * H - 24
    B -= B % 3
    b_true = B - p3
    # POOL: upper-case bases, N, lower-case bases, an invalid byte
    p = [0.7 * (1 - junk) / 4] * 4 + [0.8 * junk] + [0.3 * (1 - junk) / 4] * 4 + [0.2 * junk]
    s = rng.choice(POOL, size=B + 2 * H, p=p).astype(np.uint8)
    if p3:
        s[H + b_true :] = 0
    row = np.zeros(row4, np.uint8)
    row[: s.size] = s
    return row, (H, H + b_true, 1, b_true + 1)


def _jax_bounds(bounds):
    b = np.zeros(128, np.int32)
    b[:4] = bounds
    return jnp.asarray(b)


TBL16 = sixframe_tbl16(bytes(np.asarray(jax_standard.tbl).tobytes()))


@pytest.mark.parametrize("K,p3", [(1, 0), (5, 0), (7, 6)])
def test_k4_plain_matches_pallas_multiset(K, p3):
    row, bounds = _row(np.random.default_rng(K), K, p3, junk=0.08)
    keys, n_valid = sixframe_windows_plain(torch.from_numpy(row), K, bounds)
    hi, lo, nv = sixframe_windows_u32_pallas(
        jnp.asarray(row.view("<u4")), _jax_bounds(bounds), K, V=V, interpret=True, tbl16=TBL16
    )
    jkeys = keys_from_jax(np.asarray(hi), np.asarray(lo))
    assert keys.shape == (2 * row.size,)
    got = Counter(keys[keys != SENTINEL].tolist())
    assert got == Counter(jkeys[jkeys != SENTINEL].tolist())
    assert int(n_valid) == int(nv) == sum(got.values()) > 100


@pytest.mark.parametrize("K,p3", [(8, 0), (15, 3), (32, 0)])
def test_k5_plain_matches_pallas_multiset(K, p3):
    row, bounds = _row(np.random.default_rng(K), K, p3, junk=0.004)
    words, n_valid = sixframe_words_plain(torch.from_numpy(row), K, bounds)
    limbs, valid, nv = sixframe_windows_mw_u32_pallas(
        jnp.asarray(row.view("<u4")), _jax_bounds(bounds), K, V=V, interpret=True, tbl16=TBL16
    )
    # K5's explicit validity stream selects the real windows
    jwords = words_from_jax([np.asarray(x) for x in limbs], K, bps=8, valid=np.asarray(valid))
    assert words.shape == jwords.shape == (n_words(K, 8), 2 * row.size)
    real, jreal = words[0] != SENTINEL, jwords[0] != SENTINEL
    got = Counter(words_to_ints(words[:, real].numpy()).tolist())
    assert got == Counter(words_to_ints(jwords[:, jreal].numpy()).tolist())
    assert int(n_valid) == int(nv) == sum(got.values()) > 50


def _strand_bytes(L, seed):
    rng = np.random.default_rng(seed)
    b = np.frombuffer(b"ACGTacgtU", np.uint8)[rng.integers(0, 9, L)]
    b[rng.random(L) < 0.01] = ord("N")
    return b


@pytest.mark.parametrize("K", [2, 7, 8, 13, 32])
def test_plain_windows_match_jnp_front_end(K):
    """Forward windows element by element against ``_strand_windows(_mw)``
    on the forward stream, reverse windows against the same on the
    reverse-complement stream mapped to forward anchors (p = n - 3K - q)."""
    L = 400
    b = _strand_bytes(L, K)
    tbl = np.asarray(jax_standard.tbl)
    codes, certain, _ = jax_classify(b)
    rc_codes, rc_certain = (codes ^ 3)[::-1], certain[::-1]
    m = L - 3 * K + 1
    bounds = (5, m - 2, 0, m)
    if K <= 7:
        got, n_valid = sixframe_windows_plain(torch.from_numpy(b), K, bounds)
        got = got.reshape(2, L)[:, :m]
        strands = []
        for cs, ce, lo, hi in [(codes, certain, 5, m - 2), (rc_codes, rc_certain, 0, m)]:
            h, l, v = _strand_windows(cs, ce, K, lo, hi, tbl)
            k = keys_from_jax(np.asarray(h), np.asarray(l))
            strands.append(torch.where(torch.from_numpy(np.array(v)), k, SENTINEL))
        want = torch.stack([strands[0], strands[1].flip(0)])
    else:
        got, n_valid = sixframe_words_plain(torch.from_numpy(b), K, bounds)
        got = got.reshape(-1, 2, L)[:, :, :m]
        strands = []
        for cs, ce, lo, hi in [(codes, certain, 5, m - 2), (rc_codes, rc_certain, 0, m)]:
            limbs, v = _strand_windows_mw(cs, ce, K, lo, hi, tbl)
            strands.append(words_from_jax([np.asarray(x) for x in limbs], K, bps=8, valid=np.asarray(v)))
        want = torch.stack([strands[0], strands[1].flip(1)], 1)
    assert torch.equal(got, want)
    first = got if K <= 7 else got[0]
    assert int(n_valid) == int((first != SENTINEL).sum()) > 0


@pytest.mark.parametrize("K", [1, 8])
def test_plain_windows_take_the_genetic_code(K):
    b = torch.from_numpy(_strand_bytes(300, K))
    build = sixframe_windows_plain if K <= 7 else sixframe_words_plain
    bounds = (0, 300, 0, 300)
    std = build(b, K, bounds)[0]
    mito = build(b, K, bounds, ncbi_trans_table[2])[0]
    assert torch.equal(std == SENTINEL, mito == SENTINEL) and not torch.equal(std, mito)


@pytest.mark.parametrize("K,L", [(1, 0), (1, 2), (7, 20), (8, 23), (32, 95)])
def test_inputs_without_windows(K, L):
    build = sixframe_windows_plain if K <= 7 else sixframe_words_plain
    out, n_valid = build(torch.from_numpy(_strand_bytes(L, 0)), K, (0, L, 0, L))
    assert out.shape[-1] == 2 * L and (out == SENTINEL).all() and int(n_valid) == 0


def test_wrappers_take_the_plain_version_on_cpu():
    b = torch.from_numpy(_strand_bytes(1000, 1))
    for kernel, plain, K in [(sixframe_windows, sixframe_windows_plain, 6),
                             (sixframe_words, sixframe_words_plain, 20)]:
        before = kernel.launches
        got = kernel(b, K, (0, 1000, 3, 700))
        assert kernel.launches == before
        for g, w in zip(got, plain(b, K, (0, 1000, 3, 700))):
            assert torch.equal(g, w)


@pytest.mark.parametrize("K", [0, 8, 33])
def test_k4_k_out_of_range_raises(K):
    with pytest.raises(ValueError):
        sixframe_windows(torch.from_numpy(_strand_bytes(100, 0)), K, (0, 100, 0, 100))


@pytest.mark.parametrize("K", [7, 33])
def test_k5_k_out_of_range_raises(K):
    with pytest.raises(ValueError):
        sixframe_words(torch.from_numpy(_strand_bytes(100, 0)), K, (0, 100, 0, 100))


def test_wrappers_take_1d_uint8():
    with pytest.raises(TypeError):
        sixframe_windows(torch.zeros(10, dtype=torch.int64), 3, (0, 10, 0, 10))
    with pytest.raises(TypeError):
        sixframe_words(torch.zeros((2, 10), dtype=torch.uint8), 9, (0, 10, 0, 10))


# ---------------------------------------------------------------- conversions


def test_full_limbs_at_k8_need_the_validity_stream():
    # at K = 8 the 64-bit register fills JAX's two limbs: all-ones is a real
    # window (eight amino acids of code 0xFF), told apart only by validity
    ones = np.full(3, 0xFFFFFFFF, np.uint32)
    limbs = [ones, np.array([0xFFFFFFFF, 0, 7], np.uint32)]
    words = words_from_jax(limbs, 8, bps=8, valid=np.array([1, 0, 1]))
    assert words[:, 0].tolist() == [3, (1 << 62) - 1]
    assert (words[:, 1] == SENTINEL).all()
    assert words_to_ints(words[:, [0, 2]].numpy()).tolist() == [(1 << 64) - 1, (0xFFFFFFFF << 32) | 7]
    # without the stream all-ones reads as the sentinel
    assert (words_from_jax(limbs, 8, bps=8)[:, 0] == SENTINEL).all()


@pytest.mark.parametrize("K", [8, 9, 15, 16, 23, 24, 31, 32])
def test_aa_words_round_trip_with_jax_limbs(K):
    rng = np.random.default_rng(K)
    M = -(-8 * K // 32)
    top = 8 * K - 32 * (M - 1)
    limbs = [rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32) for _ in range(M)]
    if top < 32:
        limbs[0] &= np.uint32((1 << top) - 1)
    valid = rng.random(300) < 0.8
    words = words_from_jax(limbs, K, bps=8, valid=valid)
    assert words.shape == (n_words(K, 8), 300) and n_words(K, 8) == -(-8 * K // 62)
    real = words[:, torch.from_numpy(valid)]
    assert (real >= 0).all() and (real < (1 << 62)).all()
    assert words_to_ints(real.numpy()).tolist() == mw_to_numpy(tuple(x[valid] for x in limbs)).tolist()
    back = words_to_jax(words, K, bps=8)
    for x, y in zip(back, limbs):
        assert np.array_equal(x[valid], y[valid])
        assert (x[~valid] == 0xFFFFFFFF).all()


def test_aa_words_wider_than_8k_bits_raise():
    with pytest.raises(ValueError):
        words_from_jax([np.array([1 << 28], np.uint32)] + [np.zeros(1, np.uint32)] * 3, 15, bps=8)
    with pytest.raises(ValueError):
        words_from_jax([np.zeros(1, np.uint32)] * 3, 15, bps=8)  # K = 15 takes 4 limbs
