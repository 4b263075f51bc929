"""The port's remaining ops against the JAX package on the same inputs:
``ops.stats`` (``popcount32``, ``gc_count_u64``, ``gc_fraction_windows``),
``ops.hashing.fx_hash_words``, ``ops.windows.rc_windows_4bit_from_codes``
and ``ops.multiword``'s ``windows_mw`` and ``rc_windows_mw``, through
``convert.py``'s layout functions; and ``random.rand_kmers_device``
against the reference's format, range and alphabet rules
(``tests/test_extras.py``)."""

import numpy as np
import pytest
import torch

import kmers_tpu as jkt
from kmers_tpu.ops import u64
from kmers_tpu.ops.hashing import fx_hash_words as jax_fx_hash_words
from kmers_tpu.ops.multiword import rc_windows_mw as jax_rc_windows_mw
from kmers_tpu.ops.multiword import windows_mw as jax_windows_mw
from kmers_tpu.ops.stats import gc_count_u64 as jax_gc_count_u64
from kmers_tpu.ops.stats import gc_fraction_windows as jax_gc_fraction_windows
from kmers_tpu.ops.stats import popcount32 as jax_popcount32
from kmers_tpu.ops.windows import rc_windows_4bit_from_codes as jax_rc_windows_4bit
from kmers_tpu.random import PROTEOGENIC_AA as JAX_PROTEOGENIC_AA
import kmers_tpu_torch as tkt
from kmers_tpu_torch import ops as tops
from kmers_tpu_torch.convert import n_words, words_from_jax
from kmers_tpu_torch.ops.stats import gc_fraction_windows
from kmers_tpu_torch.random import PROTEOGENIC_AA, rand_kmers_device


def _regs(n, seed, bits=64):
    """Random int64 registers of ``bits`` bits (64: any bit pattern)."""
    raw = np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    if bits < 64:
        raw &= np.uint64((1 << bits) - 1)
    edges = np.array([0, (1 << bits) - 1, 1 << (bits - 1)], np.uint64)
    return np.concatenate([raw, edges])


def _split(regs):
    """uint64 registers as the reference's (hi, lo) uint32 pair."""
    return (regs >> np.uint64(32)).astype(np.uint32), (regs & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _joined(hi, lo):
    """The reference's (hi, lo) pair as uint64."""
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _t(regs):
    return torch.from_numpy(regs.view(np.int64).copy())


# ---------------------------------------------------------------- stats


def test_popcount32_matches_reference():
    x = _regs(2000, 1, bits=32)
    got = tops.popcount32(_t(x))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(jax_popcount32(x.astype(np.uint32))))
    # only the low 32 bits count
    assert tops.popcount32(torch.tensor([-1, 1 << 40])).tolist() == [32, 0]


@pytest.mark.parametrize("bits", [2, 30, 54, 62, 64])
def test_gc_count_matches_reference(bits):
    regs = _regs(3000, bits, bits=bits)
    got = tops.gc_count_u64(_t(regs))
    want = np.asarray(jax_gc_count_u64(*_split(regs)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_gc_count_matches_the_scalar_kmer():
    # tests/test_pipelines.py's check: windows of a DNA string, K = 27
    from kmers_tpu import DNAKmer
    from kmers_tpu_torch.ops import classify_2bit, windows_from_codes

    s = "".join(np.random.default_rng(7).choice(list("ACGT"), 300))
    codes, _, _ = classify_2bit(torch.frombuffer(bytearray(s.encode()), dtype=torch.uint8))
    got = tops.gc_count_u64(windows_from_codes(codes, 27))
    assert got.tolist() == [DNAKmer(s[i : i + 27]).count_gc() for i in range(300 - 27 + 1)]


def test_gc_fraction_matches_reference():
    regs = _regs(500, 3, bits=62)
    got = gc_fraction_windows(_t(regs))
    want = np.asarray(jax_gc_fraction_windows(*_split(regs)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # with K: the count over K.  The reference's jitted form traces K and
    # raises on ``if K:`` (ROADMAP F9), so its count is divided here
    assert np.array_equal(gc_fraction_windows(_t(regs), 31).numpy(), want / np.float32(31))
    with pytest.raises(Exception, match="Tracer"):
        jax_gc_fraction_windows(*_split(regs), 31)


# ---------------------------------------------------------------- hashing


@pytest.mark.parametrize("n_words_", [1, 2, 3, 5])
@pytest.mark.parametrize("seeded", [False, True])
def test_fx_hash_words_matches_reference(n_words_, seeded):
    words = [_regs(400, 10 * n_words_ + j) for j in range(n_words_)]
    seed = _regs(400, 99) if seeded else None
    got = tops.fx_hash_words([_t(w) for w in words], None if seed is None else _t(seed))
    want = jax_fx_hash_words([_split(w) for w in words], None if seed is None else _split(seed))
    assert np.array_equal(got.numpy().view(np.uint64), _joined(*want))


def test_fx_hash_words_chains_and_agrees_with_one_word():
    w = _t(_regs(100, 5, bits=62))
    a, b = _t(_regs(100, 6)), _t(_regs(100, 7))
    assert torch.equal(tops.fx_hash_words([a, b]), tops.fx_hash_words([b], tops.fx_hash_words([a])))
    # one word from seed 0 is fx_hash_u64 without its order-key flip
    assert torch.equal(tops.fx_hash_words([w]) ^ (-(1 << 63)), tops.fx_hash_u64(w))
    with pytest.raises(ValueError):
        tops.fx_hash_words([])


# ---------------------------------------------------------------- windows


def _codes(L, seed, high):
    return np.random.default_rng(seed).integers(0, high, L, dtype=np.uint32)


@pytest.mark.parametrize("K", [1, 2, 7, 9, 15, 16])
def test_rc_windows_4bit_matches_reference(K):
    codes = _codes(700, K, 16)
    got = tops.rc_windows_4bit_from_codes(torch.from_numpy(codes.astype(np.int64)), K)
    want = _joined(*jax_rc_windows_4bit(codes, K))
    assert got.shape == (700 - K + 1,) and np.array_equal(got.numpy().view(np.uint64), want)


def test_rc_windows_4bit_limits():
    with pytest.raises(NotImplementedError):
        tops.rc_windows_4bit_from_codes(torch.zeros(40, dtype=torch.int64), 17)
    assert tops.rc_windows_4bit_from_codes(torch.zeros(4, dtype=torch.int64), 5).shape == (0,)


@pytest.mark.parametrize(
    "K,bps", [(K, 2) for K in (1, 16, 31, 32, 33, 47, 63, 64, 100)] + [(K, 4) for K in (8, 15, 16, 17, 40)]
    + [(K, 8) for K in (4, 7, 8, 12, 32)]
)
def test_windows_mw_matches_reference(K, bps):
    codes = _codes(400, K * bps, 1 << bps)
    got = tops.windows_mw(torch.from_numpy(codes.astype(np.int64)), K, bps)
    limbs = jax_windows_mw(codes, K, bps)
    n = 400 - K + 1
    want = words_from_jax([np.asarray(x) for x in limbs], K, bps=bps, valid=np.ones(n))
    assert got.shape == (n_words(K, bps), n) and torch.equal(got, want)


@pytest.mark.parametrize("K", [1, 5, 31, 32, 33, 47, 62, 63, 64, 100])
def test_rc_windows_mw_matches_reference(K):
    codes = _codes(400, K, 4)
    got = tops.rc_windows_mw(torch.from_numpy(codes.astype(np.int64)), K)
    want = words_from_jax([np.asarray(x) for x in jax_rc_windows_mw(codes, K)], K, valid=np.ones(400 - K + 1))
    assert torch.equal(got, want)
    # the canonical register is the lexicographic minimum of the two
    fw = tops.windows_mw(torch.from_numpy(codes.astype(np.int64)), K)
    canonical = tops.canonical_windows_mw(torch.from_numpy(codes.astype(np.int64)), K)
    for c in range(0, fw.shape[1], 37):
        assert canonical[:, c].tolist() == min(fw[:, c].tolist(), got[:, c].tolist())


def test_windows_mw_short_input():
    assert tops.windows_mw(torch.zeros(3, dtype=torch.int64), 5).shape == (1, 0)
    assert tops.rc_windows_mw(torch.zeros(40, dtype=torch.int64), 50).shape == (2, 0)


# ---------------------------------------------------------------- random


def _ints(regs):
    """Registers (one int64 key or (W, n) words) as Python ints."""
    if regs.dim() == 1:
        return regs.tolist()
    out = [0] * regs.shape[1]
    for word in regs.tolist():
        out = [(o << 62) | w for o, w in zip(out, word)]
    return out


def _symbols(v, K, bps):
    return [(v >> (bps * (K - 1 - i))) & ((1 << bps) - 1) for i in range(K)]


def test_rand_kmers_device_two_bit():
    # tests/test_extras.py: raw bits in range, essentially all distinct
    g = torch.Generator().manual_seed(0)
    vals = rand_kmers_device(g, tkt.DNAAlphabet2(), 31, 500, device="cpu")
    assert vals.shape == (500,) and vals.dtype == torch.int64
    assert bool((vals >= 0).all()) and bool((vals < (1 << 62)).all())
    assert len(set(vals.tolist())) > 490
    small = rand_kmers_device(g, tkt.RNAAlphabet2, 9, 50, device="cpu")
    assert bool((small >= 0).all()) and bool((small < (1 << 18)).all())
    wide = rand_kmers_device(g, tkt.DNAAlphabet2(), 47, 64, device="cpu")
    assert wide.shape == (n_words(47), 64) and bool((wide >= 0).all())
    ints = _ints(wide)
    assert all(v < (1 << 94) for v in ints) and max(ints) >= 1 << 90
    # every bit position is set somewhere: the bits are raw and uniform
    assert all(any((v >> b) & 1 for v in ints) for b in range(94))


@pytest.mark.parametrize("K", [7, 12, 15, 16, 40])
def test_rand_kmers_device_four_bit_one_hot(K):
    g = torch.Generator().manual_seed(K)
    regs = rand_kmers_device(g, tkt.DNAAlphabet4(), K, 100, device="cpu")
    assert (regs.dim() == 1) == (4 * K <= 62)
    for v in _ints(regs):
        assert v < (1 << (4 * K))
        assert all(s in (1, 2, 4, 8) for s in _symbols(v, K, 4))


@pytest.mark.parametrize("K", [7, 8, 9, 32])
def test_rand_kmers_device_amino_acids_are_proteogenic(K):
    assert PROTEOGENIC_AA == tuple(int(c) for c in JAX_PROTEOGENIC_AA)
    g = torch.Generator().manual_seed(K)
    regs = rand_kmers_device(g, tkt.AminoAcidAlphabet(), K, 200, device="cpu")
    seen = set()
    for v in _ints(regs):
        assert v < (1 << (8 * K))
        syms = _symbols(v, K, 8)
        assert set(syms) <= set(PROTEOGENIC_AA)
        seen.update(syms)
    assert seen == set(PROTEOGENIC_AA)


def test_rand_kmers_device_is_reproducible_and_rejects_other_alphabets():
    for alphabet, K in ((tkt.DNAAlphabet2(), 40), (tkt.AminoAcidAlphabet(), 5)):
        a = rand_kmers_device(torch.Generator().manual_seed(11), alphabet, K, 64, device="cpu")
        b = rand_kmers_device(torch.Generator().manual_seed(11), alphabet, K, 64, device="cpu")
        c = rand_kmers_device(torch.Generator().manual_seed(12), alphabet, K, 64, device="cpu")
        assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(NotImplementedError):
        rand_kmers_device(torch.Generator(), tkt.CharAlphabet(), 5, 4, device="cpu")
    assert tkt.rand_kmers_device is rand_kmers_device and jkt.rand_kmers_device
