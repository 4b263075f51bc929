"""The port's FASTA/FASTQ ingestion (``kmers_tpu_torch/io``) against the JAX
package's, route by route: the native scanner (the port's own copy of
``fastx.cpp``, built by g++ at first use), the pure-Python scanner and the
default (native when built), on the fixtures and cases of
``tests/test_io.py``, gzip, streamed batches, the native table merge, and
the four inputs on which the two scanners disagree.  On every input each
port route gives what the reference's same route gives, or raises where it
raises."""

import gzip

import numpy as np
import pytest

from kmers_tpu.io import fasta as jax_fasta
from kmers_tpu_torch.io import fasta as port_fasta
from kmers_tpu_torch.io import native

FASTA = b""">chr1 description here
ACGTACGT
ACGT
>chr2
NNNACGT
>empty

>chr3
acgtn
"""

FASTQ = b"""@read1
ACGTACGT
+
IIIIIIII
@read2 desc
ACGT
+read2
!!!!
"""

#: the inputs on which the native and the Python scanners disagree
DISAGREE = {
    "'>' inside a FASTA sequence line": b">a\nAC>GT\nGG\n>b\nTT\n",
    "CRLF FASTQ": b"@r1\r\nACGT\r\n+\r\nIIII\r\n@r2\r\nGG\r\n+\r\nII\r\n",
    "blank lines between FASTQ records": b"@r1\nACGT\n+\nIIII\n\n\n@r2\nGGA\n+\nIII\n",
    "multi-line FASTQ": b"@r1\nACGT\nACG\n+\nIIII\nIII\n@r2\nTT\n+\nII\n",
}

ROUTES = [True, False, None]


def _parse(module, data, use_native):
    try:
        return module.read_fastx_bytes(data, use_native=use_native)
    except ValueError as e:
        return e


def _same(got, want):
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError), got
        return
    assert got[0].dtype == want[0].dtype == np.uint8 and got[1].dtype == want[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_native_scanner_builds_as_the_reference_does():
    assert port_fasta.native_available() and jax_fasta.native_available()


@pytest.mark.parametrize("use_native", ROUTES)
@pytest.mark.parametrize("data", [FASTA, FASTQ, b"", b">only\n", b"@q\nAC\n+\nII\n"])
def test_fixtures_match_jax(data, use_native):
    _same(_parse(port_fasta, data, use_native), _parse(jax_fasta, data, use_native))


@pytest.mark.parametrize("use_native", ROUTES)
@pytest.mark.parametrize("name", list(DISAGREE))
def test_disagreeing_inputs_match_jax_route_by_route(name, use_native):
    data = DISAGREE[name]
    _same(_parse(port_fasta, data, use_native), _parse(jax_fasta, data, use_native))


def test_disagreeing_inputs_differ_between_routes():
    # the reason each route is held against its own counterpart
    for data in DISAGREE.values():
        native_out = _parse(port_fasta, data, True)
        python_out = _parse(port_fasta, data, False)
        assert isinstance(native_out, ValueError) != isinstance(python_out, ValueError) or not (
            np.array_equal(native_out[0], python_out[0]) and np.array_equal(native_out[1], python_out[1])
        )


def test_default_route_is_native():
    data = DISAGREE["'>' inside a FASTA sequence line"]
    seq, off = port_fasta.read_fastx_bytes(data)
    assert bytes(seq[off[0] : off[1]]) == b"AC>GTGG" and off.size == 3


def test_random_crlf_fasta_both_routes_match_jax():
    rng = np.random.default_rng(5)
    blob = b""
    for i in range(20):
        n = int(rng.integers(0, 500))
        s = bytes(np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, n)])
        blob += b">rec%d\r\n" % i + b"\r\n".join(s[j : j + 60] for j in range(0, max(n, 1), 60)) + b"\r\n"
    outs = [_parse(port_fasta, blob, r) for r in (True, False)]
    _same(outs[0], outs[1])
    for r, out in zip((True, False), outs):
        _same(out, _parse(jax_fasta, blob, r))


@pytest.mark.parametrize("data", [b"not a fasta", b"\nACGT\n", b"@r1\nAC\n+\nII\nXY\n"])
def test_malformed_raises_as_jax(data):
    for use_native in ROUTES:
        _same(_parse(port_fasta, data, use_native), _parse(jax_fasta, data, use_native))
    with pytest.raises(ValueError):
        port_fasta.read_fastx_bytes(b"not a fasta")


@pytest.mark.parametrize("use_native", ROUTES)
def test_read_fastx_gzip_matches_jax(tmp_path, use_native):
    text = b">r1\nACGTACGT\nACGT\n>r2\nTTTT\n"
    (tmp_path / "a.fa").write_bytes(text)
    (tmp_path / "a.fa.gz").write_bytes(gzip.compress(text))
    for name in ("a.fa", "a.fa.gz"):
        got = port_fasta.read_fastx(tmp_path / name, use_native=use_native)
        _same(got, jax_fasta.read_fastx(tmp_path / name, use_native=use_native))
    assert bytes(got[0]) == b"ACGTACGTACGTTTTT"


def _write_fasta(path, rng, n_rec=40):
    with open(path, "wb") as f:
        for i in range(n_rec):
            s = "".join("ACGTN"[j] for j in rng.integers(0, 5, rng.integers(50, 900)))
            f.write(f">r{i} desc\n".encode())
            for k in range(0, len(s), 60):
                f.write(s[k : k + 60].encode() + b"\n")


def _write_fastq(path, rng, n_rec=60):
    with open(path, "wb") as f:
        for i in range(n_rec):
            s = "".join("ACGT"[j] for j in rng.integers(0, 4, 80))
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n".encode())


@pytest.mark.parametrize("fmt,batch", [("fa", 777), ("fq", 1000), ("fa.gz", 512), ("fq.gz", 333)])
def test_stream_batches_match_jax(tmp_path, fmt, batch):
    rng = np.random.default_rng(len(fmt) + batch)
    path = tmp_path / f"reads.{fmt}"
    (_write_fasta if fmt.startswith("fa") else _write_fastq)(tmp_path / "plain", rng)
    raw = (tmp_path / "plain").read_bytes()
    path.write_bytes(gzip.compress(raw) if fmt.endswith(".gz") else raw)
    got = list(port_fasta.stream_fastx(path, batch_bytes=batch))
    want = list(jax_fasta.stream_fastx(path, batch_bytes=batch))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _same(g, w)
    whole = port_fasta.read_fastx(path)
    assert sum(s.size for s, _ in got) == whole[0].size


def _tables(seed):
    rng = np.random.default_rng(seed)
    k1 = np.unique(rng.integers(0, 1000, 200, dtype=np.uint64))
    k2 = np.unique(rng.integers(0, 1000, 150, dtype=np.uint64))
    return k1, rng.integers(1, 9, k1.size).astype(np.int64), k2, rng.integers(1, 9, k2.size).astype(np.int64)


@pytest.mark.parametrize("native_built", [True, False])
def test_merge_count_tables_native_matches_jax(monkeypatch, native_built):
    if not native_built:
        monkeypatch.setattr(port_fasta.native, "library", lambda: None)
    cases = [_tables(1), _tables(2)[:2] + (np.zeros(0, np.uint64), np.zeros(0, np.int64)),
             (np.zeros(0, np.uint64), np.zeros(0, np.int64), np.array([5], np.uint64), np.array([2], np.int64))]
    for case in cases:
        got = port_fasta.merge_count_tables_native(*case)
        want = jax_fasta.merge_count_tables_native(*case)
        assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_without_the_library_the_readers_parse_in_python(monkeypatch):
    monkeypatch.setattr(port_fasta.native, "library", lambda: None)
    assert not port_fasta.native_available()
    data = DISAGREE["'>' inside a FASTA sequence line"]
    _same(port_fasta.read_fastx_bytes(data), _parse(jax_fasta, data, False))


def test_failed_build_gives_no_library(monkeypatch, tmp_path):
    bad = tmp_path / "fastx.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.library.__wrapped__() is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_tracks_source_and_flags(monkeypatch, tmp_path):
    src = tmp_path / "fastx.cpp"
    src.write_text("// one\n")
    monkeypatch.setattr(native, "SOURCE", src)
    first = native._digest()
    src.write_text("// two\n")
    second = native._digest()
    monkeypatch.setattr(native, "GXX_FLAGS", (*native.GXX_FLAGS, "-g"))
    assert len({first, second, native._digest()}) == 3
