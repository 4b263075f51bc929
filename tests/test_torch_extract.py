"""The port's extraction pipelines on the CPU, bit-exact against the JAX
package's: ``extract_kmers``, ``spaced_kmers``, ``minimizer_select`` (both
``skip_ambiguous`` modes), ``syncmer_select`` and ``composition_vector``
(both branches), K = 32 included (a 64-bit register, valid by the mask:
the 32-mer ``C`` + 31 ``T`` is ``0x7FFF...FF``, the port's sentinel), with
the same exception types."""

import importlib

import numpy as np
import pytest

from kmers_tpu.alphabets import EncodeError as JaxEncodeError
from kmers_tpu_torch.convert import SENTINEL
from kmers_tpu_torch.symbols import EncodeError

jex = importlib.import_module("kmers_tpu.pipelines.extract")
tex = importlib.import_module("kmers_tpu_torch.pipelines.extract")
jcc = importlib.import_module("kmers_tpu.pipelines.canonical_count")
tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")

POOL = np.frombuffer(b"ACGTacgtNR", dtype=np.uint8)
SENTINEL_32MER = b"C" + b"T" * 31


def _seq(L, seed, ambiguous=True):
    rng = np.random.default_rng(seed)
    p = np.array([0.2, 0.2, 0.2, 0.2, 0.045, 0.045, 0.045, 0.045, 0.015, 0.005])
    if not ambiguous:
        p[-2:] = 0
    return POOL[rng.choice(len(POOL), size=L, p=p / p.sum())].tobytes()


MIXED = _seq(6000, 1)[:3000] + SENTINEL_32MER + _seq(6000, 1)[3000:]
CLEAN = _seq(5000, 2, ambiguous=False) + SENTINEL_32MER


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _raises_each_own(port_fn, jax_fn):
    with pytest.raises(EncodeError):
        port_fn()
    with pytest.raises(JaxEncodeError):
        jax_fn()


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("K", [1, 7, 31, 32])
def test_extract_matches_jax(K, canonical):
    got = tex.extract_kmers(MIXED, K=K, canonical=canonical, device="cpu")
    _same(got, jex.extract_kmers(MIXED, K=K, canonical=canonical))
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64 and got[0].size > 1000


def test_extract_k32_keeps_the_sentinel_valued_kmer():
    vals, pos = tex.extract_kmers(MIXED, K=32, device="cpu")
    hit = pos[vals == np.uint64(SENTINEL)]
    assert hit.size == 1 and MIXED[hit[0] : hit[0] + 32] == SENTINEL_32MER


def test_extract_error_contract():
    bad = MIXED[:100] + b"X" + MIXED[100:]
    _raises_each_own(lambda: tex.extract_kmers(bad, K=9, device="cpu"), lambda: jex.extract_kmers(bad, K=9))
    _raises_each_own(
        lambda: tex.extract_kmers(MIXED, K=9, skip_ambiguous=False, device="cpu"),
        lambda: jex.extract_kmers(MIXED, K=9, skip_ambiguous=False),
    )
    _same(tex.extract_kmers(b"ACG", K=9, device="cpu"), jex.extract_kmers(b"ACG", K=9))
    with pytest.raises(NotImplementedError):
        tex.extract_kmers(CLEAN, K=33, device="cpu")
    with pytest.raises(NotImplementedError):
        jex.extract_kmers(CLEAN, K=33)


# J = 1 and J >= len take the reference's plain slices, the others (on
# 5,032 bases) its selection matmul; J = 9000 leaves one window
@pytest.mark.parametrize(
    "K,J,canonical",
    [(7, 3, False), (31, 5, True), (32, 4, False), (32, 9, True), (11, 1, False), (5, 7, True), (9, 9000, False),
     (1, 2, False), (16, 3, True), (31, 128, False)],
)
def test_spaced_matches_jax(K, J, canonical):
    _same(tex.spaced_kmers(CLEAN, K, J, canonical, device="cpu"), jex.spaced_kmers(CLEAN, K, J, canonical))


def test_spaced_rejects_bad_stride():
    for J in (0, -2):
        with pytest.raises(ValueError):
            tex.spaced_kmers(CLEAN, 11, J, device="cpu")
        with pytest.raises(ValueError):
            jex.spaced_kmers(CLEAN, 11, J)


def test_spaced_error_contract():
    _raises_each_own(lambda: tex.spaced_kmers(MIXED, 11, 3, device="cpu"), lambda: jex.spaced_kmers(MIXED, 11, 3))
    bad = CLEAN[:50] + b"X" + CLEAN[50:]
    _raises_each_own(lambda: tex.spaced_kmers(bad, 11, 3, device="cpu"), lambda: jex.spaced_kmers(bad, 11, 3))
    _same(tex.spaced_kmers(b"ACGT", 11, 3, device="cpu"), jex.spaced_kmers(b"ACGT", 11, 3))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("K,W", [(15, 10), (5, 1), (31, 17), (32, 4)])
def test_minimizers_skip_ambiguous_match_jax(K, W, canonical):
    got = tex.minimizer_select(MIXED, K, W, canonical, skip_ambiguous=True, device="cpu")
    _same(got, jex.minimizer_select(MIXED, K, W, canonical, skip_ambiguous=True))
    assert got[1].size > 100 and (np.diff(got[1]) > 0).all()


@pytest.mark.parametrize("K,W", [(15, 10), (32, 6)])
def test_minimizers_strict_match_jax(K, W):
    _same(tex.minimizer_select(CLEAN, K, W, device="cpu"), jex.minimizer_select(CLEAN, K, W))


def test_minimizer_error_contract():
    _raises_each_own(
        lambda: tex.minimizer_select(MIXED, 15, 10, device="cpu"), lambda: jex.minimizer_select(MIXED, 15, 10)
    )
    bad = CLEAN[:50] + b"X" + CLEAN[50:]
    _raises_each_own(
        lambda: tex.minimizer_select(bad, 15, 10, skip_ambiguous=True, device="cpu"),
        lambda: jex.minimizer_select(bad, 15, 10, skip_ambiguous=True),
    )
    _same(tex.minimizer_select(CLEAN[:20], 15, 10, device="cpu"), jex.minimizer_select(CLEAN[:20], 15, 10))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("K,s", [(15, 5), (32, 8), (9, 1)])
def test_syncmers_match_jax(K, s, canonical):
    got = tex.syncmer_select(CLEAN, K, s, canonical, device="cpu")
    _same(got, jex.syncmer_select(CLEAN, K, s, canonical))
    assert got[0].size > 50


def test_syncmer_error_contract():
    _raises_each_own(
        lambda: tex.syncmer_select(MIXED, 15, 5, device="cpu"), lambda: jex.syncmer_select(MIXED, 15, 5)
    )
    for s in (0, 15):
        with pytest.raises(ValueError):
            tex.syncmer_select(CLEAN, 15, s, device="cpu")
        with pytest.raises(ValueError):
            jex.syncmer_select(CLEAN, 15, s)
    _same(tex.syncmer_select(b"ACGT", 15, 5, device="cpu"), jex.syncmer_select(b"ACGT", 15, 5))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_composition_vector_matches_jax(K, canonical):
    got = tcc.composition_vector(MIXED, K=K, canonical=canonical, device="cpu")
    want = jcc.composition_vector(MIXED, K=K, canonical=canonical)
    assert got.shape == (4**K,) and got.sum() > 1000
    _same(got, want)


def test_composition_vector_error_contract():
    for canonical in (False, True):
        _raises_each_own(
            lambda: tcc.composition_vector(MIXED, 4, canonical, skip_ambiguous=False, device="cpu"),
            lambda: jcc.composition_vector(MIXED, 4, canonical, skip_ambiguous=False),
        )
    with pytest.raises(ValueError):
        tcc.composition_vector(MIXED, K=13, device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(tex.torch.cuda, "is_available", lambda: False)
    for fn in (tex.extract_kmers, tex.minimizer_select, tex.syncmer_select):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(CLEAN, device="cuda")
