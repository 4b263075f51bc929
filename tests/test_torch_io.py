"""The port's FASTA/FASTQ ingestion (``kmers_tpu_torch/io``) against the JAX
package's, route by route: the native scanner (``fastx.cpp``, the port's
one-pass scanner built by g++ at first use), the pure-Python scanner and the
default (native when built), on the fixtures and cases of
``tests/test_io.py``, random records, gzip, streamed batches cut inside
every line of a record, the native table merge, and the four inputs on which
the two scanners disagree.  On every input each port route gives what the
reference's same route gives, or raises where it raises.  The native N-join
of CSR records gives what the Python loop and the reference's join give."""

import gzip
import importlib

import numpy as np
import pytest

from kmers_tpu.io import fasta as jax_fasta
from kmers_tpu_torch.io import fasta as port_fasta
from kmers_tpu_torch.io import native
from kmers_tpu_torch.pipelines import join_records_with_n

jcc = importlib.import_module("kmers_tpu.pipelines.canonical_count")
jst = importlib.import_module("kmers_tpu.pipelines.streaming")
tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
tst = importlib.import_module("kmers_tpu_torch.pipelines.streaming")

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

#: odd inputs, each a path of the native scanner (some read, some rejected)
ODD = {
    "CR inside a FASTQ quality line": b"@r1\nACGT\n+\nII\rII\n@r2\nGG\n+\nII\n",
    "CR inside sequence lines": b">a\nAC\rGT\n>b\nG\rG\n",
    "CR inside a FASTQ sequence line": b"@r1\nAC\rGT\n+\nIIII\n",
    "four blank lines between FASTQ records": b"@r1\nAC\n+\nII\n\n\n\n\n@r2\nGG\n+\nII\n",
    "FASTQ quality starting with '@'": b"@r1\nACGT\n+\n@III\n@r2\nGG\n+\nII\n",
    "FASTQ quality shorter than its sequence": b"@r1\nACGT\n+\nII\n@r2\nGG\n+\nII\n",
    "FASTQ quality longer than its sequence": b"@r1\nAC\n+\nIIII\n@r2\nGG\n+\nII\n",
    "no final newline": b"@r1\nACGT\n+\nIIII\n@r2\nGG\n+\nII",
    "FASTA header at the end": b">a\nACGT\n>b",
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


def _route(monkeypatch, use_native):
    """Both packages on one route: native, or Python with no library."""
    if not use_native:
        monkeypatch.setattr(port_fasta.native, "library", lambda: None)
        monkeypatch.setattr(jax_fasta, "_lib", False)
    assert port_fasta.native_available() == jax_fasta.native_available() == use_native


def _stream(module, path, batch):
    try:
        return list(module.stream_fastx(path, batch_bytes=batch))
    except ValueError as e:
        return e


def _same_stream(got, want):
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError), got
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_native_scanner_builds_as_the_reference_does():
    assert port_fasta.native_available() and jax_fasta.native_available()


@pytest.mark.parametrize("use_native", ROUTES)
@pytest.mark.parametrize("data", [FASTA, FASTQ, b"", b">only\n", b"@q\nAC\n+\nII\n"])
def test_fixtures_match_jax(data, use_native):
    _same(_parse(port_fasta, data, use_native), _parse(jax_fasta, data, use_native))


@pytest.mark.parametrize("use_native", ROUTES)
@pytest.mark.parametrize("name", list(ODD))
def test_odd_inputs_match_jax_route_by_route(name, use_native):
    data = ODD[name]
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


def _random_fastx(rng, fastq, eol):
    """Up to 40 records of 0-300 bases, one in six empty, FASTA lines of 60."""
    out = []
    for i in range(int(rng.integers(1, 41))):
        n = 0 if rng.random() < 1 / 6 else int(rng.integers(0, 301))
        s = bytes(np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, n)])
        if fastq:
            out.append(b"@r%d" % i + eol + s + eol + b"+" + eol + b"I" * n + eol)
        else:
            out.append(b">r%d" % i + eol + eol.join(s[j : j + 60] for j in range(0, max(n, 1), 60)) + eol)
    return b"".join(out)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("eol", [b"\n", b"\r\n"], ids=["LF", "CRLF"])
@pytest.mark.parametrize("fmt", ["fa", "fq"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_records_match_jax(seed, fmt, eol, use_native):
    data = _random_fastx(np.random.default_rng(seed), fmt == "fq", eol)
    _same(_parse(port_fasta, data, use_native), _parse(jax_fasta, data, use_native))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", ["FASTA", "FASTQ", "empty", "one FASTA header", "one FASTQ record", *DISAGREE, *ODD])
def test_streamed_fixtures_and_disagreeing_inputs_match_jax(tmp_path, monkeypatch, name, use_native):
    data = {"FASTA": FASTA, "FASTQ": FASTQ, "empty": b"", "one FASTA header": b">only\n",
            "one FASTQ record": b"@q\nAC\n+\nII\n", **DISAGREE, **ODD}[name]
    _route(monkeypatch, use_native)
    path = tmp_path / "in.fx"
    path.write_bytes(data)
    for batch in (1, 5, 13, 64, 4096):
        _same_stream(_stream(port_fasta, path, batch), _stream(jax_fasta, path, batch))


#: a FASTQ record: header [0, 7), sequence line [7, 158), '+' line [158,
#: 160), quality line [160, 311); a byte of each
FQ_LINES = {"header": 3, "sequence line": 80, "plus line": 159, "quality line": 240}


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("where", list(FQ_LINES))
def test_stream_cut_inside_each_line_matches_jax(tmp_path, monkeypatch, where, use_native):
    rng = np.random.default_rng(9)
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (40, 150))]
    path = tmp_path / "reads.fq"
    path.write_bytes(b"".join(b"@r%04d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * 150) for i, r in enumerate(reads)))
    _route(monkeypatch, use_native)
    # the first block ends inside the sixth record's line
    batch = 5 * 311 + FQ_LINES[where]
    got, want = _stream(port_fasta, path, batch), _stream(jax_fasta, path, batch)
    _same_stream(got, want)
    assert len(got) > 1 and got[0][1].size == 5 + 1
    assert np.array_equal(np.concatenate([s for s, _ in got]), reads.reshape(-1))


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


def _join_case(lengths, seed=0):
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, sum(lengths))]
    return seq, np.cumsum([0, *lengths]).astype(np.int64)


#: CSR records (uint8 bytes, int64 offsets)
JOIN_CASES = {
    "none": (np.zeros(0, np.uint8), np.zeros(1, np.int64)),
    "one": _join_case([7]),
    "many": _join_case(np.random.default_rng(3).integers(0, 200, 500).tolist()),
    "empty first": _join_case([0, 5, 9]),
    "empty last": _join_case([5, 9, 0]),
    "empty in the middle": _join_case([5, 0, 0, 9]),
    "all empty": _join_case([0, 0, 0]),
}


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_native_join_matches_the_python_loop_and_jax(monkeypatch, case):
    seq, offsets = JOIN_CASES[case]
    if offsets.size > 2:
        assert port_fasta.join_records_native(seq, offsets) is not None
    got = join_records_with_n(seq, offsets)
    monkeypatch.setattr(port_fasta.native, "library", lambda: None)
    fallback = join_records_with_n(seq, offsets)
    want = jcc.join_records_with_n(seq, offsets)
    assert got.dtype == fallback.dtype == np.uint8
    assert np.array_equal(got, want) and np.array_equal(fallback, want)


@pytest.mark.parametrize("offsets", [[0, 8, 2, 10], [0, 12, 20], [3, 5, 9], [0, 4, 11], [0, -3, 10]])
def test_join_of_offsets_that_are_not_csr_matches_jax(offsets):
    seq, offsets = _join_case([10])[0], np.asarray(offsets)
    try:
        want = jcc.join_records_with_n(seq, offsets)
    except ValueError as e:
        with pytest.raises(type(e)):
            join_records_with_n(seq, offsets)
        return
    assert np.array_equal(join_records_with_n(seq, offsets), want)


@pytest.mark.parametrize("native_built", [True, False])
def test_streaming_counter_updates_with_offsets_match_jax(monkeypatch, native_built):
    if not native_built:
        monkeypatch.setattr(port_fasta.native, "library", lambda: None)
    batches = [_join_case(np.random.default_rng(s).integers(0, 90, 30).tolist(), s) for s in (4, 5)]
    sc = tst.StreamingCounter(tcc.CountConfig(K=15, chunk_size=256), device="cpu")
    ref = jst.StreamingCounter(jcc.CountConfig(K=15, chunk_size=256))
    for seq, offsets in batches:
        sc.update(seq, offsets)
        ref.update(seq, offsets)
    (gk, gc), (wk, wc) = sc.finalize(), ref.finalize()
    assert np.array_equal(gk, wk) and np.array_equal(gc, wc) and gc.sum() > 0
