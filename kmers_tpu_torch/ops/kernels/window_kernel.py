"""K1, the fused canonical front-end, in its two modes: the wrappers and
their plain versions.

Counterpart of ``kmers_tpu/ops/pallas/window_kernel.py::canonical_windows_u32_pallas``
(the kernel is ``kmers_tpu_torch/csrc/window_kernel.cu``).  Output is in
natural order, entry ``i`` for the window that starts at byte ``i``, and is
:data:`~kmers_tpu_torch.convert.SENTINEL` where any of its K bytes is not
A/C/G/T/U (either case) and for the last K-1 positions.

- :func:`canonical_windows` (register mode): the canonical register.
- :func:`canonical_hashes` (hash mode, the TPU kernel's ``emit_hash``): the
  order key of the seed-0 FxHash of the canonical register
  (``convert.py``), for minhash sketching.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...convert import SENTINEL
from ..encode import classify_2bit
from ..hashing import fx_hash_u64
from ..windows import canonical_windows_from_codes, window_valid_mask
from . import _build

__all__ = [
    "TILE",
    "canonical_windows",
    "canonical_windows_plain",
    "canonical_hashes",
    "canonical_hashes_plain",
]

#: positions one block of K1, K3, K4 and K5 owns (``kTile`` in
#: ``csrc/common.cuh``): the kernels pack its bytes, 32 to a code word, with a
#: halo of one (K1), two (K3) or five (K4, K5) words; the tests aim at these
#: edges
TILE = 1024


def _check_k(K: int) -> None:
    if not 1 <= K <= 31:
        raise ValueError(f"canonical windows support 1 <= K <= 31 (got K={K})")


def canonical_windows_plain(bytes_u8: torch.Tensor, K: int):
    """Plain torch version of :func:`canonical_windows`, on any device."""
    _check_k(K)
    codes, certain, ambig = classify_2bit(bytes_u8)
    keys = torch.full(
        (bytes_u8.shape[0],), SENTINEL, dtype=torch.int64, device=bytes_u8.device
    )
    win = canonical_windows_from_codes(codes, K)
    valid = window_valid_mask(certain, K)
    keys[: win.shape[0]] = torch.where(valid, win, SENTINEL)
    n_invalid = (~(certain | ambig)).sum()
    return keys, n_invalid, ambig.sum()


def canonical_hashes_plain(bytes_u8: torch.Tensor, K: int):
    """Plain torch version of :func:`canonical_hashes`, on any device."""
    keys, n_invalid, n_ambig = canonical_windows_plain(bytes_u8, K)
    return torch.where(keys != SENTINEL, fx_hash_u64(keys), SENTINEL), n_invalid, n_ambig


@functools.cache
def _kernel():
    v = ctypes.c_void_p
    return _build.kernel(
        "k1_canonical_windows",
        (v, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, v, v, v),
    )


def _launch(bytes_u8: torch.Tensor, K: int, emit_hash: bool, name: str):
    """Check a front-end input and launch K1 on it, in hash mode if
    ``emit_hash``; None for a CPU tensor."""
    _check_k(K)
    if bytes_u8.dtype != torch.uint8 or bytes_u8.dim() != 1:
        raise TypeError(f"{name} takes a 1-D uint8 tensor")
    if bytes_u8.device.type == "cpu":
        return None
    if bytes_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {bytes_u8.device}")
    if not bytes_u8.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    n = bytes_u8.shape[0]
    keys = torch.empty(n, dtype=torch.int64, device=bytes_u8.device)
    counters = torch.zeros(2, dtype=torch.int64, device=bytes_u8.device)
    if n:
        with torch.cuda.device(bytes_u8.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _kernel()(
                bytes_u8.data_ptr(), n, K, int(emit_hash), keys.data_ptr(),
                counters.data_ptr(), stream,
            )
        _build.check(code, "k1_canonical_windows")
        (canonical_hashes if emit_hash else canonical_windows).launches += 1
    return keys, counters[0], counters[1]


def canonical_windows(bytes_u8: torch.Tensor, K: int):
    """Canonical K-window registers of a 1-D contiguous ``uint8`` tensor.

    Returns ``(keys, n_invalid, n_ambig)``: ``keys`` int64 of the input's
    length, and 0-d int64 tensors counting the invalid and the ambiguous
    bytes (each byte once).  A CUDA tensor launches the kernel; a CPU
    tensor takes :func:`canonical_windows_plain`.
    """
    out = _launch(bytes_u8, K, False, "canonical_windows")
    return canonical_windows_plain(bytes_u8, K) if out is None else out


def canonical_hashes(bytes_u8: torch.Tensor, K: int):
    """FxHash order keys of the canonical K-window registers of a 1-D
    contiguous ``uint8`` tensor (K1's hash mode).

    Returns ``(keys, n_invalid, n_ambig)`` as :func:`canonical_windows`,
    with ``keys[i]`` the order key of the window's hash.  A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`canonical_hashes_plain`.
    """
    out = _launch(bytes_u8, K, True, "canonical_hashes")
    return canonical_hashes_plain(bytes_u8, K) if out is None else out


#: kernel launches in this process (each wrapper adds one per launch)
canonical_windows.launches = 0
canonical_hashes.launches = 0
