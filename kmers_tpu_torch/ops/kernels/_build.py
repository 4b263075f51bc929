"""Build and load the port's CUDA kernels.

Every ``kmers_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (Hopper), one process per file in parallel, and linked into ONE
shared library with a plain C interface, loaded with ``ctypes``.  The
library sits in ``kmers_tpu_torch/_build/`` under a name that carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  The build runs at the first kernel launch of a
process, never at import.

Each C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "kernel", "check", "resource_usage", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (not on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from kmers_tpu_torch/csrc at first use"
    )


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, workdir: Path) -> str:
    """Compile every source to an object in ``workdir``, one ``nvcc``
    process per source, all started together; then link them into the
    shared library ``out``.  Returns what the compiles printed: ptxas's
    registers, shared memory and spills of every kernel (``-Xptxas -v``)."""
    nvcc = _nvcc()
    sources = _sources()
    objs = [workdir / f"{src.stem}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(SRC_DIR), "-c", "-o", str(obj),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    # wait for every process before raising, so none is left running
    outputs = [p.communicate()[0] for p in procs]
    failed = [
        f"{src.name} ({p.returncode}):\n{text}"
        for src, p, text in zip(sources, procs, outputs) if p.returncode
    ]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return "".join(outputs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if no library of the
    current sources and flags exists."""
    so = BUILD_DIR / f"libkmers_kernels_{_digest()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a private directory, then rename: concurrent processes
        # never load a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = Path(work) / so.name
            _report(so).write_text(_compile(tmp, Path(work)))
            os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def _report(so: Path) -> Path:
    return so.with_suffix(".ptxas.txt")


def resource_usage() -> dict[str, str]:
    """{kernel's mangled name: ptxas's lines on it} from the report of the
    current sources' build ("Used N registers, ..." and its stack and
    spills); empty when no build of them has left a report."""
    path = _report(BUILD_DIR / f"libkmers_kernels_{_digest()}.so")
    usage, name = {}, None
    for line in path.read_text().splitlines() if path.exists() else []:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "registers" in line):
            usage[name] = f"{usage.get(name, '')}; {line.split(':')[-1].strip()}".lstrip("; ")
    return usage


def kernel(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared
    (``ctypes.c_void_p`` for pointers and the stream); returns ``int``."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        text = library().kmers_cuda_error_string
        text.argtypes = [ctypes.c_int]
        text.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {code} ({text(code).decode()})")
