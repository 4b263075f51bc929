"""The port's main path as a whole, ``kmers_tpu_torch`` canonical counting on
the CPU for 1 <= K <= 100, bit-exact against the JAX package's
``canonical_count_bytes``, ``canonical_count_records`` and
``python -m kmers_tpu count``, with the same error contract, metrics and
checked mode.  Each package raises its own ``EncodeError`` and builds its
own ``Kmer``s; those are compared by message, alphabet, text, ``repr``,
hash and count."""

import collections
import importlib
import json

import numpy as np
import pytest

import kmers_tpu_torch as kt
from kmers_tpu import UnambiguousDNAMers
from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.alphabets import EncodeError as JaxEncodeError
from kmers_tpu.utils import Metrics as JaxMetrics
from kmers_tpu.utils import checked as jax_checked
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.alphabets import DNAAlphabet2
from kmers_tpu_torch.kmer import Kmer
from kmers_tpu_torch.symbols import EncodeError
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


def _raises_each_own(data, **kw):
    """Both packages raise their own EncodeError on ``data``, with the same
    message and an alphabet of the same class."""
    with pytest.raises(EncodeError) as got:
        _port(data, **kw)
    with pytest.raises(JaxEncodeError) as want:
        _jax(data, **kw)
    assert str(got.value) == str(want.value)
    assert type(got.value.alphabet) is DNAAlphabet2
    assert type(got.value.alphabet).__name__ == type(want.value.alphabet).__name__


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
    _raises_each_own(data, K=5, chunk_size=chunk_size)
    assert not issubclass(EncodeError, JaxEncodeError) and issubclass(EncodeError, ValueError)


@pytest.mark.parametrize("chunk_size", [None, 40])
def test_ambiguous_base_contract(chunk_size):
    data = b"ACGT" * 30 + b"N" + b"ACGT" * 30
    _raises_each_own(data, K=5, chunk_size=chunk_size, skip_ambiguous=False)
    _equal(_port(data, K=5, chunk_size=chunk_size), _jax(data, K=5, chunk_size=chunk_size))


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


def _same_dict(got, want):
    """{Kmer: count} of the port and of the JAX package: the same text,
    ``repr``, hash, alphabet and counts, each key of its own package's
    class."""
    assert all(type(k) is Kmer and type(k.alphabet) is DNAAlphabet2 for k in got)
    assert all(type(k.alphabet).__name__ == "DNAAlphabet2" for k in want)
    assert {str(k): c for k, c in got.items()} == {str(k): c for k, c in want.items()}
    assert {k.value: c for k, c in got.items()} == {k.value: c for k, c in want.items()}
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    assert sorted(map(hash, got)) == sorted(map(hash, want))


def test_lookup_and_dict_match_jax():
    data = _seq(400, 10)
    kmers, counts = _port(data, K=9)
    queries = np.concatenate([kmers[:5], np.array([1, 2, 3], np.uint64)])
    assert np.array_equal(
        tcc.counts_lookup(kmers, counts, queries), jcc.counts_lookup(kmers, counts, queries)
    )
    _same_dict(tcc.counts_to_dict(kmers, counts, 9), jcc.counts_to_dict(kmers, counts, 9))


@pytest.mark.parametrize("K", [9, 47])
def test_dict_keys_are_scalar_kmers(K):
    """The table's keys are the scalar plane's ``Kmer``s: a ``kt.DNAKmer``
    of a window, made canonical, finds its count, and ``counts_lookup``
    with ``kt.DNAKmer`` queries equals the JAX package's with its own."""
    data = _seq(600, 20 + K).tobytes().decode()
    kmers, counts = _port(data, K=K)
    table = tcc.counts_to_dict(kmers, counts, K)
    windows = [data[i:i + K] for i in range(len(data) - K + 1)]
    windows = [w.upper() for w in windows if set(w.upper()) <= set("ACGT")][:25]
    assert windows
    for w in windows:
        k = kt.DNAKmer(w)
        assert table[k.canonical()] == table[k.reverse_complement().canonical()] >= 1
    from kmers_tpu import DNAKmer as JaxDNAKmer

    got = tcc.counts_lookup(kmers, counts, [kt.DNAKmer(w) for w in windows])
    want = jcc.counts_lookup(kmers, counts, [JaxDNAKmer(w) for w in windows])
    assert np.array_equal(got, want) and (got >= 1).all()


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


# ---------------------------------------------------------------- K > 31

MW_POOL = np.frombuffer(b"ACGTacgtNR", dtype=np.uint8)


def _seq_mw(L, seed):
    """Mostly certain bases, so that long windows survive, with a 250-base
    unit copied three times, so that registers repeat across chunks."""
    rng = np.random.default_rng(seed)
    p = np.array([0.24, 0.24, 0.24, 0.24, 0.005, 0.005, 0.005, 0.005, 0.004, 0.001])
    s = MW_POOL[rng.choice(len(MW_POOL), size=L, p=p / p.sum())]
    for at in (300, 700, 1200):
        if at + 250 <= L:
            s[at : at + 250] = s[:250]
    return s


def _equal_mw(a, b):
    assert a[0].dtype == b[0].dtype == object
    assert a[1].dtype == b[1].dtype == np.int64
    assert a[0].tolist() == [int(x) for x in b[0]] and np.array_equal(a[1], b[1])
    assert a[0].tolist() == sorted(a[0].tolist())


_JAX_MW_ONE_CHUNK = {}


def _jax_mw_one_chunk(K):
    # the JAX answer with its Pallas front-end (interpret mode here) for
    # K <= 63 and jnp above, as its pipeline routes them; one chunk per K,
    # since interpret mode takes seconds a call
    if K not in _JAX_MW_ONE_CHUNK:
        _JAX_MW_ONE_CHUNK[K] = _jax(_seq_mw(1500, K), K=K, use_pallas=True)
    return _JAX_MW_ONE_CHUNK[K]


@pytest.mark.parametrize("chunk_size", [None, 150, 1000])
@pytest.mark.parametrize("K", [32, 33, 47, 48, 63, 64, 100])
def test_matches_jax_multiword(K, chunk_size):
    got = _port(_seq_mw(1500, K), K=K, chunk_size=chunk_size)
    want = _jax_mw_one_chunk(K)
    _equal_mw(got, want)
    assert got[1].max() >= 3  # the repeated unit was counted across chunks


@pytest.mark.parametrize("K,chunk_size", [(47, 300), (64, 200)])
def test_matches_jax_multiword_chunked(K, chunk_size):
    data = _seq_mw(1500, 200 + K)
    _equal_mw(
        _port(data, K=K, chunk_size=chunk_size),
        _jax(data, K=K, chunk_size=chunk_size, use_pallas=True),
    )


def test_multiword_matches_scalar_plane_counter():
    s = _seq_mw(2000, 12).tobytes().decode()
    K = 47
    oracle = collections.Counter(x.canonical().value for x, _ in UnambiguousDNAMers(K, s))
    kmers, counts = _port(s, K=K, chunk_size=512)
    assert dict(zip(kmers.tolist(), counts.tolist())) == dict(oracle)


def test_multiword_shorter_than_k():
    got = _port(b"ACGT" * 10, K=47)
    _equal_mw(got, _jax(b"ACGT" * 10, K=47))
    assert got[0].size == 0
    with pytest.raises(ValueError):
        _port(b"ACGT" * 30, K=47, chunk_size=40)


@pytest.mark.parametrize("chunk_size", [None, 60])
def test_multiword_error_contract(chunk_size):
    clean = _seq_mw(400, 3)
    clean[clean == ord("N")] = ord("A")
    clean[clean == ord("R")] = ord("C")
    _raises_each_own(np.concatenate([clean, np.frombuffer(b"X", np.uint8), clean]), K=40, chunk_size=chunk_size)
    ambiguous = np.concatenate([clean, np.frombuffer(b"N", np.uint8), clean])
    _raises_each_own(ambiguous, K=40, chunk_size=chunk_size, skip_ambiguous=False)
    _equal_mw(_port(ambiguous, K=40, chunk_size=chunk_size), _jax(ambiguous, K=40, chunk_size=chunk_size))


def test_multiword_records_match_jax():
    recs = [_seq_mw(n, n) for n in (600, 45, 900)]
    seq = np.concatenate(recs)
    offsets = np.cumsum([0] + [r.size for r in recs])
    cfg = dict(K=47, chunk_size=128)
    got = tcc.canonical_count_records(seq, offsets, tcc.CountConfig(**cfg), device="cpu")
    want = jcc.canonical_count_records(seq, offsets, jcc.CountConfig(**cfg))
    _equal_mw(got, want)


def test_multiword_lookup_and_dict_match_jax():
    K = 47
    kmers, counts = _port(_seq_mw(1500, 13), K=K)
    # present registers, absent ones, and Kmer objects (looked up canonically)
    queries = [*kmers[:4].tolist(), 0, 1 << 93]
    assert np.array_equal(
        tcc.counts_lookup(kmers, counts, queries), jcc.counts_lookup(kmers, counts, queries)
    )
    rc = Kmer.unsafe(DNAAlphabet2(), K, int(kmers[3])).reverse_complement()
    assert tcc.counts_lookup(kmers, counts, rc).tolist() == [int(counts[3])]
    _same_dict(tcc.counts_to_dict(kmers, counts, K), jcc.counts_to_dict(kmers, counts, K))


@pytest.mark.parametrize("chunk_size", [None, 77, 1 << 19, 1 << 20])
@pytest.mark.parametrize("K", [1, 31, 32, 47, 100])
def test_resolved_chunk_size_matches_jax(K, chunk_size):
    got = tcc.CountConfig(K=K, chunk_size=chunk_size).resolved_chunk_size
    assert got == jcc.CountConfig(K=K, chunk_size=chunk_size).resolved_chunk_size


def test_multiword_records_no_metrics_batch_as_jax():
    # a gap of the reference kept by the port: K > 31 records no batch
    data = _seq_mw(600, 14)
    m, jm = Metrics(), JaxMetrics()
    tcc.canonical_count_bytes(data, tcc.CountConfig(K=40), metrics=m, device="cpu")
    jcc.canonical_count_bytes(data, jcc.CountConfig(K=40), metrics=jm)
    assert m.summary()["n_batches"] == jm.summary()["n_batches"] == 0


def test_cli_matches_jax_cli_k47(tmp_path, capsys):
    recs = [_seq_mw(n, n).tobytes().decode() for n in (1500, 60, 700)]
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(recs)))
    port_main(["count", str(fa), "-k", "47", "--top", "4", "--device", "cpu"])
    got = capsys.readouterr()
    jax_main(["count", str(fa), "-k", "47", "--top", "4"])
    want = capsys.readouterr()
    assert got.out == want.out and len(got.out.splitlines()) == 4
    assert json.loads(got.err) == json.loads(want.err)
