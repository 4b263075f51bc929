"""MinHash sketching of the port on the CPU, bit-exact against the JAX
package's jnp route (``use_pallas=False``): ``minhash_sketch`` over K and
sketch sizes (K = 32 through plain torch), the full-width fallback on
repetitive input, the error contract, ``StreamingSketcher`` (with its
``metrics``), ``sketch_fastx_stream`` on FASTA and gzipped FASTQ,
``jaccard``, and the CLI's ``sketch`` and ``dist``; and inputs of 0 to 4
windows, where the reference's jnp route raises (ROADMAP F5), against the
scalar plane's ``fx_hash`` over ``CanonicalDNAMers``."""

import gzip
import importlib
import json

import numpy as np
import pytest

from kmers_tpu import CanonicalDNAMers, fx_hash
from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.alphabets import EncodeError as JaxEncodeError
from kmers_tpu.utils import Metrics as JaxMetrics
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.symbols import EncodeError
from kmers_tpu_torch.utils import Metrics

jmh = importlib.import_module("kmers_tpu.pipelines.minhash")
tmh = importlib.import_module("kmers_tpu_torch.pipelines.minhash")

POOL = np.frombuffer(b"ACGTacgtNR", dtype=np.uint8)


def _seq(L, seed):
    rng = np.random.default_rng(seed)
    p = np.array([0.2, 0.2, 0.2, 0.2, 0.045, 0.045, 0.045, 0.045, 0.015, 0.005])
    return POOL[rng.choice(len(POOL), size=L, p=p / p.sum())].tobytes()


DATA = _seq(20_000, 1)


@pytest.mark.parametrize("s", [1, 100, 1000])
@pytest.mark.parametrize("K", [1, 16, 21, 31, 32])
def test_sketch_matches_jax(K, s):
    got = tmh.minhash_sketch(DATA, K=K, s=s, device="cpu")
    want = jmh.minhash_sketch(DATA, K=K, s=s, use_pallas=False)
    assert got.dtype == want.dtype == np.uint64
    assert got.size == min(s, want.size) and np.array_equal(got, want)


def test_repetitive_input_takes_the_full_width_fallback(monkeypatch):
    rng = np.random.default_rng(3)
    unit = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 150)]
    data = np.resize(unit, 20_000).tobytes()  # ~150 distinct 21-mers
    prefixes = []
    smallest = tmh._smallest

    def spy(keys, prefix, s):
        prefixes.append((prefix, keys.shape[0]))
        return smallest(keys, prefix, s)

    monkeypatch.setattr(tmh, "_smallest", spy)
    got = tmh.minhash_sketch(data, K=21, s=100, device="cpu")
    assert prefixes == [(400, 20_000), (20_000, 20_000)]
    assert np.array_equal(got, jmh.minhash_sketch(data, K=21, s=100, use_pallas=False))
    prefixes.clear()
    tmh.minhash_sketch(DATA, K=21, s=100, device="cpu")
    assert prefixes == [(400, 20_000)]  # random input: the prefix is exact


@pytest.mark.parametrize("data", [b"", b"ACGT", "ACGTACGTAC"])
def test_shorter_than_k(data):
    got = tmh.minhash_sketch(data, K=16, s=10, device="cpu")
    assert got.dtype == np.uint64 and got.size == jmh.minhash_sketch(data, K=16, s=10, use_pallas=False).size


def test_error_contract():
    bad = DATA[:500] + b"X" + DATA[500:1000]
    with pytest.raises(EncodeError):
        tmh.minhash_sketch(bad, K=11, s=50, device="cpu")
    with pytest.raises(JaxEncodeError):
        jmh.minhash_sketch(bad, K=11, s=50, use_pallas=False)
    ambiguous = b"ACGTTGCA" * 20 + b"R" + b"ACGTTGCA" * 20
    for skip in (True, False):
        try:
            want = jmh.minhash_sketch(ambiguous, K=5, s=20, skip_ambiguous=skip, use_pallas=False)
        except JaxEncodeError:
            assert not skip
            with pytest.raises(EncodeError):
                tmh.minhash_sketch(ambiguous, K=5, s=20, skip_ambiguous=skip, device="cpu")
        else:
            assert skip
            assert np.array_equal(tmh.minhash_sketch(ambiguous, K=5, s=20, skip_ambiguous=skip, device="cpu"), want)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(tmh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tmh.minhash_sketch(DATA, K=11, device="cuda")


def _records(n, seed):
    rng = np.random.default_rng(seed)
    return [_seq(int(rng.integers(5, 3000)), seed + i) for i in range(n)]


@pytest.mark.parametrize("K", [15, 32])
def test_streaming_sketcher_matches_jax(K):
    recs = _records(12, K)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in recs])]).astype(np.int64)
    seq = np.frombuffer(b"".join(recs), np.uint8)
    got = tmh.StreamingSketcher(K=K, s=200, chunk_size=4096, device="cpu")
    want = jmh.StreamingSketcher(K=K, s=200, chunk_size=4096, use_pallas=False)
    for lo, hi in [(0, 5), (5, 6), (6, 12)]:
        part = seq[offsets[lo] : offsets[hi]]
        got.update(part, offsets[lo : hi + 1] - offsets[lo])
        want.update(part, offsets[lo : hi + 1] - offsets[lo])
    got.update(seq[:100])  # a batch without offsets
    want.update(seq[:100])
    assert got.bases_seen == want.bases_seen
    a, b = got.finalize(), want.finalize()
    assert a.size == 200 and np.array_equal(a, b)
    with pytest.raises(RuntimeError):
        got.update(seq[:100])


def test_streaming_sketch_equals_one_shot():
    recs = _records(8, 40)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in recs])])
    sk = tmh.StreamingSketcher(K=21, s=300, chunk_size=1000, device="cpu")
    sk.update(b"".join(recs), offsets)
    joined = tmh.join_records_with_n(np.frombuffer(b"".join(recs), np.uint8), offsets)
    assert np.array_equal(sk.finalize(), tmh.minhash_sketch(joined, K=21, s=300, device="cpu"))


def _write_fasta(path, recs):
    path.write_bytes(b"".join(b">r%d\n%s\n" % (i, r) for i, r in enumerate(recs)))


def _write_fastq_gz(path, recs):
    text = b"".join(b"@q%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)) for i, r in enumerate(recs))
    path.write_bytes(gzip.compress(text))


@pytest.mark.parametrize("fmt", ["fasta", "fastq.gz"])
def test_sketch_fastx_stream_matches_jax(tmp_path, fmt):
    recs = _records(20, 7)
    path = tmp_path / f"reads.{fmt}"
    (_write_fasta if fmt == "fasta" else _write_fastq_gz)(path, recs)
    got = tmh.sketch_fastx_stream(path, K=17, s=150, batch_bytes=2000, chunk_size=5000, device="cpu")
    want = jmh.sketch_fastx_stream(path, K=17, s=150, batch_bytes=2000, chunk_size=5000)
    assert got.size == 150 and np.array_equal(got, want)


def test_jaccard_matches_jax():
    rng = np.random.default_rng(9)
    pool = np.unique(rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64, endpoint=True))
    a = np.sort(rng.choice(pool, 1000, replace=False))
    b = np.sort(rng.choice(pool, 700, replace=False))
    for s in (None, 10, 500):
        assert tmh.jaccard(a, b, s) == jmh.jaccard(a, b, s)
    assert tmh.jaccard(a, a[:0]) == 0.0


def test_cli_sketch_and_dist_match_jax(tmp_path, capsys):
    fa = tmp_path / "a.fa"
    fq = tmp_path / "b.fq.gz"
    recs = _records(10, 21)
    _write_fasta(fa, recs)
    _write_fastq_gz(fq, recs[3:] + _records(4, 99))

    def both(args):
        port_main([*args, "--device", "cpu"])
        port = capsys.readouterr()
        jax_main(args)
        ref = capsys.readouterr()
        assert port.out == ref.out and port.err == ref.err
        return port.out

    out = both(["sketch", str(fa), "-k", "13", "-s", "200"])
    lines = out.splitlines()
    assert lines[0] == "#kmers_tpu sketch k=13 s=200" and len(lines) == 201
    assert all(len(line) == 16 for line in lines[1:])
    assert both(["sketch", str(fq), "-k", "13", "-s", "200", "--stream"]).startswith("#kmers_tpu")
    sk_a, sk_b = tmp_path / "a.sk", tmp_path / "b.sk"
    sk_a.write_text(out)
    sk_b.write_text(both(["sketch", str(fq), "-k", "13", "-s", "200"]))
    dist = both(["dist", str(sk_a), str(sk_b), "-k", "13", "-s", "200"])
    assert set(json.loads(dist)) == {"jaccard", "mash_distance"}
    fq_plain = tmp_path / "b.fq"
    fq_plain.write_bytes(gzip.decompress(fq.read_bytes()))
    assert both(["dist", str(fa), str(fq_plain), "-k", "13", "-s", "200"]) == dist
    headerless = tmp_path / "c.sk"
    headerless.write_text("\n".join(out.splitlines()[1:]) + "\n")
    both(["dist", str(headerless), str(sk_b), "-k", "13"])
    with pytest.raises(SystemExit):
        port_main(["dist", str(sk_a), str(sk_b), "-k", "15", "--device", "cpu"])


def test_streaming_metrics():
    # tests/test_extras.py::TestMinHash::test_streaming_metrics
    rng = np.random.default_rng(0xCCFB2D5055D8C990 % 2**32)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000)).encode()
    m = Metrics()
    sk = tmh.StreamingSketcher(K=16, s=50, chunk_size=2048, metrics=m, device="cpu")
    sk.update(seq)
    out = sk.finalize()
    (stats,) = m.batches
    assert stats.bases_in == 5000 and stats.windows_out == 5000 - 16 + 1
    assert stats.windows_skipped == 0 and stats.distinct_kmers == out.size == 50
    assert stats.seconds > 0


def test_streaming_metrics_match_jax_with_records():
    recs = _records(9, 3) + [b"ACG"]  # a record shorter than K has no window
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in recs])]).astype(np.int64)
    seq = np.frombuffer(b"".join(recs), np.uint8)
    stats = []
    for make, metrics in [(lambda m: tmh.StreamingSketcher(K=21, s=100, chunk_size=4096, metrics=m,
                                                           device="cpu"), Metrics()),
                          (lambda m: jmh.StreamingSketcher(K=21, s=100, chunk_size=4096, metrics=m,
                                                           use_pallas=False), JaxMetrics())]:
        sk = make(metrics)
        sk.update(seq[: offsets[4]], offsets[:5])
        sk.update(seq[offsets[4] :], offsets[4:] - offsets[4])
        sk.update(seq[:50])
        sk.finalize()
        (b,) = metrics.batches
        stats.append((b.bases_in, b.windows_out, b.windows_skipped, b.distinct_kmers))
    assert stats[0] == stats[1]
    assert stats[0][1] == sum(max(len(r) - 20, 0) for r in recs) + 50 - 20


F5_INPUT = b"TCCCTCCCACtCCTAGCTA"  # K = 16: 4 windows


@pytest.mark.parametrize("length", [0, 15, 16, 17, 18, 19])
def test_zero_to_four_windows_match_the_scalar_plane(length):
    data = F5_INPUT[:length]
    want = sorted({fx_hash(k) for k in CanonicalDNAMers(16, data.decode())})[:10]
    got = tmh.minhash_sketch(data, K=16, s=10, device="cpu")
    assert got.dtype == np.uint64 and got.tolist() == want
    assert len(want) == max(length - 15, 0)


def test_the_reference_jnp_route_raises_on_four_windows():
    # the fault the scalar-plane test pins (ROADMAP F5); neither package changes
    with pytest.raises(ValueError, match="top_k"):
        jmh.minhash_sketch(F5_INPUT, K=16, s=10, use_pallas=False)
