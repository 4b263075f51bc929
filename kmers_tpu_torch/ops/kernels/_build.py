"""Build and load the port's CUDA kernels.

Every ``kmers_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into ONE shared library with a plain C interface,
loaded with ``ctypes``.  The library sits in ``kmers_tpu_torch/_build/``
under a name that carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  The build runs
at the first kernel launch of a process, never at import.

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

__all__ = ["library", "kernel", "check", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if no library of the
    current sources and flags exists."""
    so = BUILD_DIR / f"libkmers_kernels_{_digest()}.so"
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent processes never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", tmp,
                 *map(str, _sources())],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(so))


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
