"""The port's count-table checkpoints (``utils/checkpoint.py``) and the CLI's
``count -o``, ``merge`` and ``verify``, against the JAX package: a table
written by either package loads bit-equal in the other (K = 31 and K = 47,
one and two partitions), the manifests are equal, and the CLI prints the
JAX CLI's lines and exits as it does.  The cases are those of
``tests/test_extras.py::TestUtils`` (checkpoints) and ``tests/test_cli.py``
(``count -o``, ``merge``, the K mismatch, ``verify``)."""

import collections
import hashlib
import json

import numpy as np
import pytest

from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.utils import checkpoint as jax_ckpt
from kmers_tpu_torch import CountConfig, canonical_count_bytes
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.utils import checkpoint as port_ckpt
from kmers_tpu_torch.utils import input_manifest_entry, load_count_table, save_count_table

PACKAGES = {"port": port_ckpt, "jax": jax_ckpt}


def _table(K, seed):
    rng = np.random.default_rng(seed)
    if K <= 31:
        kmers = np.unique(rng.integers(0, 1 << (2 * K), 300, dtype=np.uint64))
    else:
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 700))
        kmers, _ = canonical_count_bytes(seq, CountConfig(K=K), device="cpu")
        assert kmers.dtype == object and int(max(kmers)) >= 2**64
    return kmers, rng.integers(1, 1 << 40, len(kmers)).astype(np.int64)


def _same_table(a, b):
    (ka, ca, Ka), (kb, cb, Kb) = a, b
    assert Ka == Kb and ka.dtype == kb.dtype and np.array_equal(ca, cb)
    assert [int(v) for v in ka] == [int(v) for v in kb]


@pytest.mark.parametrize("K", [31, 47])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_tables_load_bit_equal_across_packages(tmp_path, K, writer, reader):
    kmers, counts = _table(K, K)
    PACKAGES[writer].save_count_table(tmp_path, kmers, counts, K=K)
    got = PACKAGES[reader].load_count_table(tmp_path, return_manifest=True)
    _same_table(got[:3], (kmers, counts, K))
    assert got[3] == {"K": K, "n_partitions": 1, "format": "kmers_tpu.counts.v1"}


@pytest.mark.parametrize("K", [31, 47])
def test_partitions_merge_as_in_jax(tmp_path, K):
    (k1, c1), (k2, c2) = _table(K, 1), _table(K, 2)
    k2 = np.concatenate([k1[::3], k2])  # shared keys sum
    c2 = np.concatenate([c1[::3], c2])
    order = np.argsort([int(v) for v in k2], kind="stable")
    k2, c2 = k2[order], c2[order]
    for name, pkg in PACKAGES.items():
        pkg.save_count_table(tmp_path / name, k1, c1, K=K, partition=0, n_partitions=2)
        pkg.save_count_table(tmp_path / name, k2, c2, K=K, partition=1, n_partitions=2)
    got = load_count_table(tmp_path / "jax")
    _same_table(got, jax_ckpt.load_count_table(tmp_path / "port"))
    want = collections.Counter()
    for k, c in [*zip(k1, c1), *zip(k2, c2)]:
        want[int(k)] += int(c)
    assert dict(zip((int(v) for v in got[0]), got[1].tolist())) == dict(want)
    assert [int(v) for v in got[0]] == sorted(want)


def test_input_manifest(tmp_path):
    src = tmp_path / "reads.fa"
    src.write_bytes(b">r1\nACGTACGT\n")
    save_count_table(tmp_path / "ckpt", np.array([3, 9], np.uint64), np.array([2, 1], np.int64),
                     K=31, inputs=[src])
    _, _, _, manifest = load_count_table(tmp_path / "ckpt", return_manifest=True)
    (entry,) = manifest["inputs"]
    assert entry == {"path": str(src), "bytes": src.stat().st_size,
                     "sha256": hashlib.sha256(src.read_bytes()).hexdigest()}
    assert entry == jax_ckpt.input_manifest_entry(src) == input_manifest_entry(src)
    assert jax_ckpt.load_count_table(tmp_path / "ckpt", return_manifest=True)[3] == manifest


@pytest.fixture
def fasta(tmp_path):
    rng = np.random.default_rng(1)
    p = tmp_path / "reads.fa"
    reads = ["".join("ACGT"[i] for i in rng.integers(0, 4, 120)) for _ in range(8)]
    p.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    return p


def _both(capsys, args, port_args=("--device", "cpu"), written=None):
    """Run the port's and the JAX CLI on ``args``; returns their stdout
    lines after checking that the two are equal.  With ``written`` (a
    checkpoint directory the command writes), also checks that the two
    write tables that load bit-equal."""
    port_main([*map(str, args), *port_args])
    port = capsys.readouterr()
    tables = [load_count_table(written)] if written else []
    jax_main(list(map(str, args)))
    ref = capsys.readouterr()
    assert port.out == ref.out and port.err == ref.err
    if written:
        _same_table(tables[0], jax_ckpt.load_count_table(written))
    return port.out


@pytest.mark.parametrize("k", [15, 40])
def test_cli_count_output_and_merge_match_jax(fasta, tmp_path, capsys, k):
    d1, d2, dm = tmp_path / "t1", tmp_path / "t2", tmp_path / "merged"
    out = _both(capsys, ["count", fasta, "-k", k, "-o", d1], written=d1)
    assert json.loads(out) == {"distinct": json.loads(out)["distinct"], "total": 8 * (120 - k + 1),
                               "output": str(d1)}
    _both(capsys, ["count", fasta, "-k", k, "-o", d2], written=d2)
    merged = json.loads(_both(capsys, ["merge", d1, d2, "-o", dm], written=dm))
    k1, c1, K = load_count_table(d1)
    km, cm, Km = load_count_table(dm)
    assert K == Km == k and [int(v) for v in km] == [int(v) for v in k1]
    assert np.array_equal(cm, 2 * c1) and merged["total"] == int(2 * c1.sum())
    assert merged["spectrum_1_to_8plus"][0] == 0  # no k-mer is seen once now


def test_cli_merge_k_mismatch_exits(fasta, tmp_path, capsys):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    port_main(["count", str(fasta), "-k", "15", "-o", str(d1), "--device", "cpu"])
    port_main(["count", str(fasta), "-k", "17", "-o", str(d2), "--device", "cpu"])
    capsys.readouterr()
    messages = []
    for main, extra in [(port_main, ["--device", "cpu"]), (jax_main, [])]:
        with pytest.raises(SystemExit) as exc:
            main(["merge", str(d1), str(d2), "-o", str(tmp_path / "m"), *extra])
        messages.append(str(exc.value))
    assert messages[0] == messages[1] == f"K mismatch: {d2} has K=17, expected 15"


def test_cli_verify_matches_jax(fasta, tmp_path, capsys):
    _both(capsys, ["count", fasta, "-k", "15", "-o", tmp_path / "tbl"])
    rep = json.loads(_both(capsys, ["verify", tmp_path / "tbl"], port_args=()))
    assert rep["ok"] and rep["inputs_checked"] == 1 and rep["K"] == 15
    with open(fasta, "ab") as f:
        f.write(b">extra\nACGT\n")
    outs = []
    for main in (port_main, jax_main):
        with pytest.raises(SystemExit) as exc:
            main(["verify", str(tmp_path / "tbl")])
        assert exc.value.code == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    rep = json.loads(outs[0])
    assert not rep["ok"] and rep["inputs_changed"][0]["found"]["bytes"] == fasta.stat().st_size


def test_cli_verify_without_inputs_exits(tmp_path):
    save_count_table(tmp_path, np.array([1], np.uint64), np.array([1], np.int64), K=31)
    with pytest.raises(SystemExit, match="no input manifest"):
        port_main(["verify", str(tmp_path)])
