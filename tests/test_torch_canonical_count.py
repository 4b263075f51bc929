"""The port's main path as a whole, ``kmers_tpu_torch`` canonical counting on
the CPU, bit-exact against the JAX package's ``canonical_count_bytes``,
``canonical_count_records`` and ``python -m kmers_tpu count``, with the same
error contract, metrics and checked mode."""

import collections
import importlib
import json

import numpy as np
import pytest

from kmers_tpu import UnambiguousDNAMers
from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.alphabets import EncodeError
from kmers_tpu.utils import Metrics as JaxMetrics
from kmers_tpu.utils import checked as jax_checked
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.utils import Metrics, checked, checked_mode

# (each package's ``pipelines`` exports a function of the module's name)
jcc = importlib.import_module("kmers_tpu.pipelines.canonical_count")
tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")

POOL = np.frombuffer(b"ACGTacgtNR", dtype=np.uint8)


def _seq(L, seed):
    rng = np.random.default_rng(seed)
    p = np.array([0.2, 0.2, 0.2, 0.2, 0.04, 0.04, 0.04, 0.04, 0.03, 0.01])
    return POOL[rng.choice(len(POOL), size=L, p=p / p.sum())]


def _port(data, **kw):
    return tcc.canonical_count_bytes(data, tcc.CountConfig(**kw), device="cpu")


def _jax(data, **kw):
    return jcc.canonical_count_bytes(data, jcc.CountConfig(**kw))


def _equal(a, b):
    assert a[0].dtype == b[0].dtype == np.uint64
    assert a[1].dtype == b[1].dtype == np.int64
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


_JAX_ONE_CHUNK = {}


def _jax_one_chunk(K):
    # JAX's own answer for the whole input in one dispatch; its multi-chunk
    # answers are the same (held by the JAX package's tests) and compile a
    # merge per table size, so only a few cases below run them
    if K not in _JAX_ONE_CHUNK:
        _JAX_ONE_CHUNK[K] = _jax(_seq(1500, K), K=K)
    return _JAX_ONE_CHUNK[K]


@pytest.mark.parametrize("chunk_size", [None, 64, 100, 1000])
@pytest.mark.parametrize("K", [1, 7, 21, 31])
def test_matches_jax(K, chunk_size):
    # 1500 bases: at chunk_size 64, 100 and 1000 the last chunk is short
    _equal(_port(_seq(1500, K), K=K, chunk_size=chunk_size), _jax_one_chunk(K))


@pytest.mark.parametrize("K,chunk_size", [(31, 100), (7, 1000), (21, 64)])
def test_matches_jax_chunked(K, chunk_size):
    data = _seq(600, 100 + K)
    _equal(_port(data, K=K, chunk_size=chunk_size), _jax(data, K=K, chunk_size=chunk_size))


def test_shorter_than_k():
    _equal(_port(b"ACGTA", K=7), _jax(b"ACGTA", K=7))
    assert _port(b"ACGTA", K=7)[0].size == 0


def test_chunk_smaller_than_k_raises():
    for fn in (_port, _jax):
        with pytest.raises(ValueError):
            fn(b"ACGT" * 20, K=11, chunk_size=10)


@pytest.mark.parametrize("chunk_size", [None, 40])
def test_invalid_byte_raises(chunk_size):
    data = b"ACGT" * 30 + b"X" + b"ACGT" * 30
    for fn in (_port, _jax):
        with pytest.raises(EncodeError):
            fn(data, K=5, chunk_size=chunk_size)


@pytest.mark.parametrize("chunk_size", [None, 40])
def test_ambiguous_base_contract(chunk_size):
    data = b"ACGT" * 30 + b"N" + b"ACGT" * 30
    for fn in (_port, _jax):
        with pytest.raises(EncodeError):
            fn(data, K=5, chunk_size=chunk_size, skip_ambiguous=False)
    _equal(_port(data, K=5, chunk_size=chunk_size), _jax(data, K=5, chunk_size=chunk_size))


def test_k_above_31_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(b"ACGT" * 20, K=40)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcc.canonical_count_bytes(b"ACGT" * 20, tcc.CountConfig(K=5), device="cuda")


def test_records_match_jax():
    recs = [_seq(n, n) for n in (300, 45, 500)]
    seq = np.concatenate(recs)
    offsets = np.cumsum([0] + [r.size for r in recs])
    cfg = dict(K=15, chunk_size=128)
    got = tcc.canonical_count_records(seq, offsets, tcc.CountConfig(**cfg), device="cpu")
    want = jcc.canonical_count_records(seq, offsets, jcc.CountConfig(**cfg))
    _equal(got, want)
    assert np.array_equal(tcc.join_records_with_n(seq, offsets), jcc.join_records_with_n(seq, offsets))
    with pytest.raises(ValueError):
        tcc.canonical_count_records(seq, offsets, tcc.CountConfig(K=15, skip_ambiguous=False), device="cpu")


@pytest.mark.parametrize("chunk_size", [None, 200])
def test_metrics_match_jax(chunk_size):
    data = _seq(900, 5)
    m, jm = Metrics(), JaxMetrics()
    tcc.canonical_count_bytes(data, tcc.CountConfig(K=21, chunk_size=chunk_size), metrics=m, device="cpu")
    jcc.canonical_count_bytes(data, jcc.CountConfig(K=21, chunk_size=chunk_size), metrics=jm)
    got, want = m.summary(), jm.summary()
    for d in (got, want):
        d.pop("seconds")
        d.pop("bases_per_sec")
    assert got == want
    assert got["windows_out"] > 0 and got["windows_skipped"] > 0


@pytest.mark.parametrize("chunk_size", [None, 200])
def test_checked_mode_matches_jax(chunk_size):
    data = _seq(900, 6)
    with checked():
        got = _port(data, K=11, chunk_size=chunk_size)
    with jax_checked():
        want = _jax(data, K=11, chunk_size=chunk_size)
    _equal(got, want)


def test_checked_mode_catches_a_lost_count(monkeypatch):
    real = tcc.sort_count

    def lossy_sort_count(keys, valid=None, key_bits=None):
        uniq, counts, n_unique = real(keys, valid, key_bits)
        counts = counts.clone()
        counts[int(counts.argmax())] -= 1
        return uniq, counts, n_unique

    monkeypatch.setattr(tcc, "sort_count", lossy_sort_count)
    data = _seq(500, 8)
    _port(data, K=9)  # unchecked: the loss goes unseen
    with checked(), pytest.raises(RuntimeError, match="conservation"):
        _port(data, K=9)


def test_matches_scalar_plane_counter():
    s = _seq(700, 9).tobytes().decode()
    K = 13
    oracle = collections.Counter(x.canonical().value for x, _ in UnambiguousDNAMers(K, s))
    kmers, counts = _port(s, K=K, chunk_size=90)
    assert dict(zip(kmers.tolist(), counts.tolist())) == dict(oracle)


def test_lookup_and_dict_match_jax():
    data = _seq(400, 10)
    kmers, counts = _port(data, K=9)
    queries = np.concatenate([kmers[:5], np.array([1, 2, 3], np.uint64)])
    assert np.array_equal(
        tcc.counts_lookup(kmers, counts, queries), jcc.counts_lookup(kmers, counts, queries)
    )
    assert tcc.counts_to_dict(kmers, counts, 9) == jcc.counts_to_dict(kmers, counts, 9)


def test_cli_matches_jax_cli(tmp_path, capsys):
    recs = [_seq(n, n).tobytes().decode() for n in (250, 40, 333)]
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(recs)))
    port_main(["count", str(fa), "-k", "11", "--top", "5", "--metrics", "--checked", "--device", "cpu"])
    got = capsys.readouterr()
    assert not checked_mode()  # restored after the run
    jax_main(["count", str(fa), "-k", "11", "--top", "5", "--metrics", "--checked"])
    want = capsys.readouterr()
    assert got.out == want.out and len(got.out.splitlines()) == 5
    gm, gt = (json.loads(x) for x in got.err.strip().splitlines())
    wm, wt = (json.loads(x) for x in want.err.strip().splitlines())
    assert gt == wt
    for d in (gm, wm):
        d.pop("seconds")
        d.pop("bases_per_sec")
    assert gm == wm
