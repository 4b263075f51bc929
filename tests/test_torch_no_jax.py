"""The port never imports jax, nor anything of the JAX package
``kmers_tpu``: a fresh interpreter imports ``kmers_tpu_torch``, runs the
counting path (K = 7 and K = 40), minhash sketching, extraction,
minimizers, six-frame counting (K = 7 and K = 15), a ``StreamingCounter``,
``merge_counts_device``, ``bench`` at a small L, the bitonic sort, the
parallel plane (sharded counting at K = 7 and K = 40 and sharded minimizers
over three CPU ranks), the native
FASTA scanner, a count-table checkpoint round trip, ``profile_step`` and the
CLI's ``count`` (also with ``--stream`` and ``-o``), ``sketch``, the
sharded ``sixframe``, ``merge`` and ``verify`` on the CPU, and finds neither in
``sys.modules``; and no source of the port or of ``chip_smoke.py`` has such
an import."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# 'NN' splits the stream into 49 runs of 16 certain bases (10 windows of
# K = 7 each) and two end runs of 8 (2 windows each)
DATA = b"ACGTTGCANNacgtaacc" * 50
TOTAL = 49 * 10 + 2 * 2

# 120 certain bases: 120 - 40 + 1 windows of K = 40, in two chunks
DATA_40 = b"ACGT" * 30

# 200 certain bases: 2 (200 - 3K + 1) six-frame windows of K amino acids
DATA_AA = b"ACGTTGCAAC" * 20

SCRIPT = f"""
import json, sys
import torch
import kmers_tpu_torch
from kmers_tpu_torch import parallel as par
from kmers_tpu_torch.__main__ import main
from kmers_tpu_torch.io import native_available, read_fastx
from kmers_tpu_torch.ops import bitonic_sort
from kmers_tpu_torch.pipelines.canonical_count import bench
from kmers_tpu_torch.utils import load_count_table, profile_step, save_count_table
kmers, counts = kmers_tpu_torch.canonical_count_bytes(
    {DATA!r}, kmers_tpu_torch.CountConfig(K=7, chunk_size=100), device="cpu",
)
kmers40, counts40 = kmers_tpu_torch.canonical_count_bytes(
    {DATA_40!r}, kmers_tpu_torch.CountConfig(K=40, chunk_size=64), device="cpu",
)
sketch = kmers_tpu_torch.minhash_sketch({DATA!r}, K=7, s=5, device="cpu")
vals, pos = kmers_tpu_torch.extract_kmers({DATA!r}, K=7, device="cpu")
mins, _ = kmers_tpu_torch.minimizer_select({DATA!r}, K=7, W=4, skip_ambiguous=True, device="cpu")
aa7, aa_counts7 = kmers_tpu_torch.sixframe_aa_count(
    {DATA_AA!r}, kmers_tpu_torch.SixFrameCountConfig(K=7), device="cpu",
)
aa15, aa_counts15 = kmers_tpu_torch.sixframe_aa_count(
    {DATA_AA!r}, kmers_tpu_torch.SixFrameCountConfig(K=15, chunk_size=100), device="cpu",
)
mesh = par.data_mesh(3, device="cpu")
pk, pc = par.sharded_canonical_count({DATA!r}, par.ShardedCountConfig(K=7, chunk_size=100), mesh)
pk40, pc40 = par.sharded_canonical_count_mw({DATA_40!r}, K=40, mesh=mesh)
pmins, _ = par.sharded_minimizer_select({DATA!r}, K=7, W=4, mesh=mesh, skip_ambiguous=True)
paa7, _ = par.sharded_sixframe_aa_count({DATA_AA!r}, par.SixFrameCountConfig(K=7, chunk_size=60), mesh)
paa15, _ = par.sharded_sixframe_aa_count({DATA_AA!r}, par.SixFrameCountConfig(K=15), mesh)
from kmers_tpu_torch.ops import encode_table, fx_hash_words, gc_count_u64, windows_mw
codes, valid = encode_table(torch.frombuffer(bytearray({DATA!r}), dtype=torch.uint8), kmers_tpu_torch.DNAAlphabet4)
regs = kmers_tpu_torch.rand_kmers_device(torch.Generator().manual_seed(1), kmers_tpu_torch.AminoAcidAlphabet(), 9, 8,
                                         device="cpu")
extras = [int(valid.sum()), int(gc_count_u64(windows_mw(codes[:40] & 3, 20)[0]).sum() >= 0),
          int(fx_hash_words([regs[0]]).shape[0]), regs.shape[0]]
sc = kmers_tpu_torch.StreamingCounter(kmers_tpu_torch.CountConfig(K=7, chunk_size=100), device="cpu")
sc.update({DATA!r})
streamed, streamed_counts = sc.finalize()
merged, merged_counts = kmers_tpu_torch.merge_counts_device(kmers, counts, streamed, streamed_counts, device="cpu")
line = bench(L=1 << 12, device="cpu")
keys = torch.arange(2048, 0, -1) * 7
ordered = bitonic_sort(keys, 256)
save_count_table(sys.argv[2] + "/t40", kmers40, counts40, K=40)
back40, back_counts40, K40 = load_count_table(sys.argv[2] + "/t40")
top = profile_step(lambda: kmers_tpu_torch.canonical_count_bytes({DATA!r}, kmers_tpu_torch.CountConfig(K=7),
                                                              device="cpu"), reps=1, top=3)
main(["count", sys.argv[1], "-k", "5", "--top", "1", "--device", "cpu"])
main(["count", sys.argv[1], "-k", "5", "--top", "1", "--stream", "--device", "cpu"])
main(["sketch", sys.argv[1], "-k", "5", "-s", "3", "--device", "cpu"])
main(["sixframe", sys.argv[1], "-k", "2", "--device", "cpu"])
main(["count", sys.argv[1], "-k", "5", "-o", sys.argv[2] + "/a", "--device", "cpu"])
main(["merge", sys.argv[2] + "/a", sys.argv[2] + "/a", "-o", sys.argv[2] + "/m", "--device", "cpu"])
main(["verify", sys.argv[2] + "/a"])
print(json.dumps({{
    "total": int(counts.sum()),
    "total40": int(counts40.sum()),
    "sketch": int(sketch.size),
    "extracted": int(vals.size),
    "minimizers": bool(mins.size),
    "sharded": pk.tolist() == kmers.tolist() and pc.tolist() == counts.tolist(),
    "sharded40": [int(x) for x in pk40] == [int(x) for x in kmers40] and pc40.tolist() == counts40.tolist(),
    "sharded_minimizers": pmins.tolist() == mins.tolist(),
    "sharded_aa": paa7.tolist() == aa7.tolist() and [int(x) for x in paa15] == [int(x) for x in aa15],
    "extras": extras,
    "aa7": int(aa_counts7.sum()),
    "aa15": int(aa_counts15.sum()),
    "streamed": int(streamed_counts.sum()),
    "merged": int(merged_counts.sum()),
    "bench": sorted(line),
    "sorted": ordered.tolist() == sorted(keys.tolist()),
    "native": native_available() and read_fastx(sys.argv[1])[1].tolist() == [0, 12, 19],
    "checkpoint": back40.tolist() == kmers40.tolist() and back_counts40.tolist() == counts40.tolist(),
    "profiled": len(top),
    "jax": "jax" in sys.modules,
    "kmers_tpu": sorted(m for m in sys.modules if m.split(".")[0] == "kmers_tpu"),
}}))
"""


def test_port_runs_without_importing_jax(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTACGGTTAC\n>b\nTTGACCA\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(fa), str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    # the CLI's top lines (loaded, then streamed), its sketch (a header and
    # three hashes), its six-frame totals, the lines of count -o, merge and
    # verify, then the script's result
    assert len(lines) == 11 and lines[0] == lines[1] and lines[2] == "#kmers_tpu sketch k=5 s=3"
    # six-frame windows of 2 amino acids (6 bases) inside each record
    assert json.loads(lines[6])["total"] == 2 * ((12 - 5) + (7 - 5))
    written, merged, verified = (json.loads(x) for x in lines[7:10])
    assert written["total"] == (12 - 4) + (7 - 4) and merged["total"] == 2 * written["total"]
    assert verified["ok"] and verified["inputs_checked"] == 1
    assert json.loads(lines[-1]) == {
        "total": TOTAL, "total40": 4 * 30 - 40 + 1, "sketch": 5, "extracted": TOTAL,
        "minimizers": True, "sharded": True, "sharded40": True, "sharded_minimizers": True,
        "sharded_aa": True, "extras": [len(DATA), 1, 8, 2],
        "aa7": 2 * (200 - 21 + 1), "aa15": 2 * (200 - 45 + 1),
        "streamed": TOTAL, "merged": 2 * TOTAL,
        "bench": ["metric", "unit", "value", "vs_baseline"], "sorted": True, "native": True,
        "checkpoint": True, "profiled": 3, "jax": False, "kmers_tpu": [],
    }
    # the totals of both count commands
    totals = [json.loads(x) for x in proc.stderr.strip().splitlines()[-2:]]
    assert totals[0] == totals[1] and totals[0]["total"] == (12 - 4) + (7 - 4)


SOURCES = [*(ROOT / "kmers_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]


def test_sources_hold_the_new_modules():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {
        "kmers_tpu_torch/io/native/__init__.py", "kmers_tpu_torch/utils/checkpoint.py",
        "kmers_tpu_torch/utils/profiling.py", "kmers_tpu_torch/ops/kernels/sort_kernel.py",
        "kmers_tpu_torch/parallel/__init__.py", "kmers_tpu_torch/parallel/mesh.py",
        "kmers_tpu_torch/parallel/pipeline.py", "kmers_tpu_torch/parallel/minimizers.py",
        "kmers_tpu_torch/parallel/multiword.py", "kmers_tpu_torch/parallel/sixframe.py",
        "kmers_tpu_torch/alphabets.py", "kmers_tpu_torch/random.py", "kmers_tpu_torch/ops/stats.py",
    } <= names


def test_port_sources_do_not_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    for path in SOURCES:
        assert not pattern.search(path.read_text()), path


# ``kmers_tpu`` followed by anything but more of a name (``kmers_tpu_torch``)
JAX_PACKAGE_IMPORT = re.compile(r"^\s*(import|from)\s+kmers_tpu(?![\w])", re.M)


def test_port_sources_do_not_import_the_jax_package():
    for path in SOURCES:
        assert not JAX_PACKAGE_IMPORT.search(path.read_text()), path


def test_jax_package_import_pattern():
    for line in ("from kmers_tpu.kmer import Kmer", "import kmers_tpu", "  from kmers_tpu import io"):
        assert JAX_PACKAGE_IMPORT.search(line), line
    for line in ("from kmers_tpu_torch import convert", "import kmers_tpu_torch", "# from kmers_tpu"):
        assert not JAX_PACKAGE_IMPORT.search(line), line
