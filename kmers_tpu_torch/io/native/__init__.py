"""Build and load the native FASTA/FASTQ scanner and N-join (``fastx.cpp``).

``g++ -O3 -shared -fPIC`` compiles ``fastx.cpp`` at first use into
``kmers_tpu_torch/_build/``, under a name that carries a hash of the source
and the flags (as ``ops/kernels/_build.py`` names the kernel library), so an
edited source is rebuilt and a stale library is never loaded.  The library
is loaded with ``ctypes``.  :func:`library` returns ``None`` when the build
or the load fails; the readers then parse in pure Python, as the JAX
package's readers do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "GXX_FLAGS"]

SOURCE = Path(__file__).resolve().with_name("fastx.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8, i64, u64 = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int64, ctypes.c_uint64))
    lib.fastx_scan.restype = ctypes.c_int
    lib.fastx_scan.argtypes = [u8, ctypes.c_int64, ctypes.c_int, u8, ctypes.POINTER(i64), i64, i64, i64]
    lib.fastx_free.restype = None
    lib.fastx_free.argtypes = [i64]
    lib.fastx_join_n.restype = ctypes.c_int
    lib.fastx_join_n.argtypes = [u8, ctypes.c_int64, i64, ctypes.c_int64, u8]
    lib.merge_count_tables.restype = ctypes.c_int64
    lib.merge_count_tables.argtypes = [u64, i64, ctypes.c_int64, u64, i64, ctypes.c_int64, u64, i64]
    return lib


@functools.cache
def library() -> ctypes.CDLL | None:
    """The loaded scanner, built first if no library of the current source
    and flags exists; ``None`` when it cannot be built or loaded."""
    so = BUILD_DIR / f"libfastx_{_digest()}.so"
    try:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build in a private directory, then rename: concurrent processes
            # never load a half-written library
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
                tmp = Path(work) / so.name
                subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so)
        return _declare(ctypes.CDLL(str(so)))
    except (OSError, subprocess.SubprocessError):
        return None
