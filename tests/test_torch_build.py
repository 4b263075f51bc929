"""The port's kernel build (``kmers_tpu_torch/ops/kernels/_build.py``) and
its register conversions (``kmers_tpu_torch/convert.py``), on the CPU."""

import sys

import numpy as np
import pytest

from kmers_tpu_torch import convert
from kmers_tpu_torch.ops.kernels import _build


def test_missing_nvcc_raises_and_says_so(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_tracks_sources_and_flags(monkeypatch, tmp_path):
    (tmp_path / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build._digest()
    (tmp_path / "a.cu").write_text("// two\n")
    second = _build._digest()
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-G"))
    assert len({first, second, _build._digest()}) == 3


def test_sources_are_the_kernels():
    names = {p.name for p in _build._sources()}
    assert {
        "window_kernel.cu", "rle_kernel.cu", "multiword_kernel.cu", "general_kernel.cu",
        "sixframe_kernel.cu", "merge_kernel.cu", "minimizer_kernel.cu",
    } <= names


# stands in for nvcc: logs its arguments, writes its -o file, and fails on
# a source named bad.cu
FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if any(a.endswith("bad.cu") for a in args):
    print("bad.cu: error")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").close()
"""


def _fake_nvcc(monkeypatch, tmp_path, sources):
    src = tmp_path / "src"
    src.mkdir()
    for name in sources:
        (src / name).write_text("// kernel\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return log


def test_compile_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path):
    log = _fake_nvcc(monkeypatch, tmp_path, ["a.cu", "b.cu"])
    out = tmp_path / "lib.so"
    _build._compile(out, tmp_path)
    calls = log.read_text().splitlines()
    compiles = sorted(c for c in calls if " -c " in c)
    assert len(calls) == 3 and len(compiles) == 2
    assert compiles[0].endswith("a.cu") and compiles[1].endswith("b.cu")
    link = next(c for c in calls if " -c " not in c)
    assert "-shared" in link and link.endswith(f"{tmp_path}/a.o {tmp_path}/b.o")
    assert out.exists()


def test_compile_failure_names_the_source(monkeypatch, tmp_path):
    log = _fake_nvcc(monkeypatch, tmp_path, ["a.cu", "bad.cu"])
    with pytest.raises(RuntimeError, match="bad.cu"):
        _build._compile(tmp_path / "lib.so", tmp_path)
    # both sources were compiled, and nothing was linked
    assert len(log.read_text().splitlines()) == 2


def test_keys_round_trip_with_sentinel():
    hi = np.array([0, 1, 0x3FFFFFFF, 0xFFFFFFFF], np.uint32)
    lo = np.array([5, 0, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    keys = convert.keys_from_jax(hi, lo)
    assert keys.tolist() == [5, 1 << 32, (1 << 62) - 1, convert.SENTINEL]
    back_hi, back_lo = convert.keys_to_jax(keys)
    assert np.array_equal(back_hi, hi) and np.array_equal(back_lo, lo)


def test_keys_wider_than_62_bits_raise():
    with pytest.raises(ValueError):
        convert.keys_from_jax(np.array([0x40000000], np.uint32), np.array([0], np.uint32))


def test_table_from_jax_keeps_real_rows():
    uh = np.array([0, 0xFFFFFFFF, 0, 0xFFFFFFFF], np.uint32)
    ul = np.array([3, 0xFFFFFFFF, 9, 0xFFFFFFFF], np.uint32)
    cnt = np.array([2, 0, 7, 0], np.int32)
    keys, counts = convert.table_from_jax(uh, ul, cnt)
    assert keys.tolist() == [3, 9] and counts.tolist() == [2, 7]


def test_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_digest", lambda: "abc")
    assert _build.resource_usage() == {}
    (tmp_path / "libkmers_kernels_abc.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1kPl' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kPl\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 1456 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z1jPl' for 'sm_90a'\n"
        "ptxas info    : Used 12 registers\n"
    )
    assert _build.resource_usage() == {
        "_Z1kPl": "0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads; "
                  "Used 40 registers, used 1 barriers, 1456 bytes smem",
        "_Z1jPl": "Used 12 registers",
    }


def test_compile_asks_ptxas_for_its_report(monkeypatch, tmp_path):
    log = _fake_nvcc(monkeypatch, tmp_path, ["a.cu"])
    # the fake nvcc prints nothing for a good source
    assert _build._compile(tmp_path / "lib.so", tmp_path) == ""
    compile_ = next(c for c in log.read_text().splitlines() if " -c " in c)
    assert "-Xptxas -v" in compile_
