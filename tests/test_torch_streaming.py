"""Streamed counting on the CPU: ``kmers_tpu_torch``'s ``StreamingCounter``
and ``count_fastx_stream`` against the JAX package's, bit-exact, with the
same errors, tallies and metrics, and the CLI's ``count --stream`` against
the JAX CLI's."""

import importlib
import json

import numpy as np
import pytest

from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.alphabets import EncodeError as JaxEncodeError
from kmers_tpu.utils import Metrics as JaxMetrics
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.symbols import EncodeError
from kmers_tpu_torch.utils import Metrics

# (each package's ``pipelines`` exports a function of the module's name)
jst = importlib.import_module("kmers_tpu.pipelines.streaming")
tst = importlib.import_module("kmers_tpu_torch.pipelines.streaming")
jcc = importlib.import_module("kmers_tpu.pipelines.canonical_count")
tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")

POOL = np.frombuffer(b"ACGTacgtNR", dtype=np.uint8)


def _seq(L, seed):
    rng = np.random.default_rng(seed)
    p = np.array([0.2, 0.2, 0.2, 0.2, 0.04, 0.04, 0.04, 0.04, 0.03, 0.01])
    return POOL[rng.choice(len(POOL), size=L, p=p / p.sum())]


def _records(seed, n, lmin, lmax):
    rng = np.random.default_rng(seed)
    recs = [_seq(int(m), seed + i) for i, m in enumerate(rng.integers(lmin, lmax, n))]
    return np.concatenate(recs), np.cumsum([0] + [r.size for r in recs])


def _equal(got, want):
    assert got[0].dtype == want[0].dtype == np.uint64
    assert got[1].dtype == want[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _both(K, chunk_size, batches, metrics=False):
    """Feed ``batches`` (``(seq, offsets)`` pairs; offsets may be None) to a
    port and a JAX counter; returns both results, tallies and metrics."""
    out = []
    for pkg, cfg, kw, mk in (
        (tst, tcc.CountConfig, {"device": "cpu"}, Metrics),
        (jst, jcc.CountConfig, {}, JaxMetrics),
    ):
        m = mk() if metrics else None
        sc = pkg.StreamingCounter(cfg(K=K, chunk_size=chunk_size), metrics=m, **kw)
        for seq, off in batches:
            sc.update(seq, off)
        out.append((sc.finalize(), sc.bases_seen, m))
    return out


@pytest.mark.parametrize("K,chunk_size", [(31, 160), (15, 128), (7, 1000), (21, None)])
def test_batches_of_records_match_jax(K, chunk_size):
    # several batches of records, small chunks: many merges on the stack
    batches = [_records(s, 4, 20, 250) for s in (1, 2, 3)]
    (got, gbases, _), (want, wbases, _) = _both(K, chunk_size, batches)
    _equal(got, want)
    assert gbases == wbases and got[1].sum() > 0


def test_one_chunk_batch_then_others():
    # the first batch fits one chunk: its table is front-packed before it
    # joins the stack, so later merges take sorted tables
    batches = [(_seq(150, 4), None), _records(5, 4, 100, 600), (_seq(90, 6), None), (b"ACG", None)]
    (got, gbases, _), (want, wbases, _) = _both(11, 200, batches)
    _equal(got, want)
    assert gbases == wbases == 150 + (batches[1][1][-1] + 3) + 90 + 3


def test_matches_canonical_count_records():
    seq, off = _records(7, 12, 10, 300)
    sc = tst.StreamingCounter(tcc.CountConfig(K=13, chunk_size=128), device="cpu")
    sc.update(seq, off)
    _equal(sc.finalize(), tcc.canonical_count_records(seq, off, tcc.CountConfig(K=13), device="cpu"))


def test_empty_and_short_streams():
    for batches in ([], [(b"ACG", None)], [(b"", None), (b"NNNNNNNNNN", None)]):
        (got, gbases, _), (want, wbases, _) = _both(5, None, batches)
        _equal(got, want)
        assert gbases == wbases and got[0].size == 0


def test_metrics_match_jax():
    batches = [_records(8, 5, 50, 500), (_seq(700, 9), None)]
    (got, _, gm), (want, _, wm) = _both(9, 256, batches, metrics=True)
    _equal(got, want)
    gs, ws = gm.summary(), wm.summary()
    for d in (gs, ws):
        d.pop("seconds")
        d.pop("bases_per_sec")
    assert gs == ws and gs["n_batches"] == 1 and gs["windows_skipped"] > 0


def test_config_errors_match_jax():
    for kw, msg in [
        (dict(K=32), "K <= 31"),
        (dict(K=21, skip_ambiguous=False), "skip_ambiguous=True"),
        (dict(K=21, chunk_size=20), "chunk_size must be >= K"),
    ]:
        with pytest.raises(ValueError, match=msg) as port_err:
            tst.StreamingCounter(tcc.CountConfig(**kw), device="cpu")
        with pytest.raises(ValueError, match=msg) as jax_err:
            jst.StreamingCounter(jcc.CountConfig(**kw))
        assert str(port_err.value) == str(jax_err.value)


def test_invalid_byte_and_update_after_finalize():
    for pkg, cfg, kw, err in ((tst, tcc.CountConfig, {"device": "cpu"}, EncodeError),
                              (jst, jcc.CountConfig, {}, JaxEncodeError)):
        sc = pkg.StreamingCounter(cfg(K=5), **kw)
        sc.update(b"ACGTACGTAC!GTACGT")
        with pytest.raises(err, match="stream input"):
            sc.finalize()
        with pytest.raises(RuntimeError, match=r"finalize\(\) already called"):
            sc.update(b"ACGTACGT")


def test_conservation_check_catches_a_lost_count(monkeypatch):
    real = tcc.sort_count

    def lossy_sort_count(keys, valid=None, key_bits=None):
        uniq, counts, n_unique = real(keys, valid, key_bits)
        counts = counts.clone()
        counts[int(counts.argmax())] -= 1
        return uniq, counts, n_unique

    monkeypatch.setattr(tcc, "sort_count", lossy_sort_count)
    sc = tst.StreamingCounter(tcc.CountConfig(K=9), device="cpu")
    sc.update(_seq(500, 10))
    with pytest.raises(RuntimeError, match="window conservation violated"):
        sc.finalize()


def _write(path, seq, off, fastq):
    recs = [seq[a:b].tobytes().decode() for a, b in zip(off[:-1], off[1:])]
    if fastq:
        path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(recs)))
    else:
        path.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(recs)))


@pytest.mark.parametrize("fastq", [False, True])
def test_count_fastx_stream_matches_jax(tmp_path, fastq):
    seq, off = _records(11, 30, 40, 400)
    path = tmp_path / ("reads.fq" if fastq else "reads.fa")
    _write(path, seq, off, fastq)
    cfg = dict(K=15, chunk_size=2048)
    got = tst.count_fastx_stream(path, tcc.CountConfig(**cfg), batch_bytes=999, device="cpu")
    want = jst.count_fastx_stream(path, jcc.CountConfig(**cfg), batch_bytes=999)
    _equal(got, want)
    _equal(got, tcc.canonical_count_records(seq, off, tcc.CountConfig(**cfg), device="cpu"))


def test_cli_count_stream_matches_jax_cli(tmp_path, capsys):
    seq, off = _records(12, 8, 60, 300)
    fa = tmp_path / "reads.fa"
    _write(fa, seq, off, False)
    port_main(["count", str(fa), "-k", "15", "--stream", "--top", "4", "--metrics", "--device", "cpu"])
    got = capsys.readouterr()
    jax_main(["count", str(fa), "-k", "15", "--stream", "--top", "4", "--metrics"])
    want = capsys.readouterr()
    assert got.out == want.out and len(got.out.splitlines()) == 4
    gm, gt = (json.loads(x) for x in got.err.strip().splitlines())
    wm, wt = (json.loads(x) for x in want.err.strip().splitlines())
    assert gt == wt and gt["total"] > 0
    for d in (gm, wm):
        d.pop("seconds")
        d.pop("bases_per_sec")
    assert gm == wm
