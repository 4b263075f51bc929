"""K4 and K5, the six-frame amino-acid front-ends (K <= 7 one int64 key a
window; 8 <= K <= 32 multi-word registers): their wrappers and their
plain versions.

Counterpart of ``kmers_tpu/ops/pallas/sixframe_kernel.py``
(``sixframe_windows_u32_pallas`` and ``sixframe_windows_mw_u32_pallas``;
the kernels are ``kmers_tpu_torch/csrc/sixframe_kernel.cu``).  Output is
in natural order, the forward window at anchor ``p`` in column ``p`` and
the reverse one in column ``n + p`` (the TPU kernels' order is a tile
relabelling, "irrelevant — a sort follows"); see ``ops/sixframe.py`` for
the windows, the bounds and the register layout.  The genetic code is a
runtime argument: its dual table (``genetic_codes.sixframe_tbl16``) is
passed to the kernel with each launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...convert import n_words
from ...genetic_codes import GeneticCode, sixframe_tbl16, standard_genetic_code
from ..sixframe import K_MAX, sixframe_windows_from_bytes, sixframe_words_from_bytes
from . import _build

__all__ = [
    "sixframe_windows",
    "sixframe_windows_plain",
    "sixframe_words",
    "sixframe_words_plain",
]

#: K of K4's one-key registers (8K <= 56 bits); K5 takes K4_MAX + 1 .. K_MAX
K4_MAX = 7


def sixframe_windows_plain(
    bytes_u8: torch.Tensor, K: int, bounds, code: GeneticCode = standard_genetic_code
):
    """Plain torch version of :func:`sixframe_windows`, on any device."""
    return sixframe_windows_from_bytes(bytes_u8, K, bounds, code)


def sixframe_words_plain(
    bytes_u8: torch.Tensor, K: int, bounds, code: GeneticCode = standard_genetic_code
):
    """Plain torch version of :func:`sixframe_words`, on any device."""
    return sixframe_words_from_bytes(bytes_u8, K, bounds, code)


@functools.cache
def _kernel(name: str):
    v, ll = ctypes.c_void_p, ctypes.c_longlong
    return _build.kernel(name, (v, ll, ctypes.c_int, ll, ll, ll, ll, v, v, v, v))


@functools.lru_cache(maxsize=64)
def _host_table(code: GeneticCode):
    return (ctypes.c_uint16 * 64)(*sixframe_tbl16(code))


def _launch(wrapper, name: str, bytes_u8, K: int, bounds, code, W: int):
    """Allocate the ``(W, 2n)`` output and the counter, launch ``name`` and
    count the launch on ``wrapper``."""
    n = bytes_u8.shape[0]
    out = torch.empty((W, 2 * n), dtype=torch.int64, device=bytes_u8.device)
    n_valid = torch.zeros(1, dtype=torch.int64, device=bytes_u8.device)
    if n:
        fw_lo, fw_hi, rv_lo, rv_hi = (int(b) for b in bounds)
        with torch.cuda.device(bytes_u8.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _kernel(name)(
                bytes_u8.data_ptr(), n, K, fw_lo, fw_hi, rv_lo, rv_hi,
                _host_table(code), out.data_ptr(), n_valid.data_ptr(), stream,
            )
        _build.check(status, name)
        wrapper.launches += 1
    return out, n_valid[0]


def _use_kernel(bytes_u8: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if bytes_u8.dtype != torch.uint8 or bytes_u8.dim() != 1:
        raise TypeError(f"{what} takes a 1-D uint8 tensor")
    if bytes_u8.device.type == "cpu":
        return False
    if bytes_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {bytes_u8.device}")
    if not bytes_u8.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")
    return True


def sixframe_windows(
    bytes_u8: torch.Tensor, K: int, bounds, code: GeneticCode = standard_genetic_code
):
    """K4: both strands' amino-acid K-window keys (1 <= K <= 7) of a 1-D
    contiguous ``uint8`` tensor of ASCII bases.

    ``bounds = (fw_lo, fw_hi, rv_lo, rv_hi)``: the anchors each strand
    emits.  Returns ``(keys, n_valid)``: ``keys`` int64 of shape ``(2n,)``
    and the 0-d int64 count of emitted windows.  A CUDA tensor launches
    the kernel; a CPU tensor takes :func:`sixframe_windows_plain`.
    """
    if not 1 <= K <= K4_MAX:
        raise ValueError(f"K4 supports 1 <= K <= {K4_MAX} (got K={K})")
    if not _use_kernel(bytes_u8, "sixframe_windows"):
        return sixframe_windows_plain(bytes_u8, K, bounds, code)
    keys, n_valid = _launch(sixframe_windows, "k4_sixframe_windows", bytes_u8, K, bounds, code, 1)
    return keys[0], n_valid


def sixframe_words(
    bytes_u8: torch.Tensor, K: int, bounds, code: GeneticCode = standard_genetic_code
):
    """K5: both strands' amino-acid K-window registers (8 <= K <= 32) of
    a 1-D contiguous ``uint8`` tensor, as words.

    Returns ``(words, n_valid)``: ``words`` int64 of shape
    ``(n_words(K, 8), 2n)``, :data:`~kmers_tpu_torch.convert.SENTINEL` in
    every word of a column not emitted.  A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`sixframe_words_plain`.
    """
    if not K4_MAX < K <= K_MAX:
        raise ValueError(f"K5 supports {K4_MAX + 1} <= K <= {K_MAX} (got K={K})")
    if not _use_kernel(bytes_u8, "sixframe_words"):
        return sixframe_words_plain(bytes_u8, K, bounds, code)
    return _launch(sixframe_words, "k5_sixframe_words", bytes_u8, K, bounds, code, n_words(K, 8))


#: kernel launches in this process (each wrapper adds one per launch)
sixframe_windows.launches = 0
sixframe_words.launches = 0
