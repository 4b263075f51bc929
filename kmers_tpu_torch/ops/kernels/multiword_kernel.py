"""K3, the fused canonical front-end for 32 <= K <= 63 (multi-word
registers): its wrapper and its plain version.

Counterpart of ``kmers_tpu/ops/pallas/multiword_kernel.py::canonical_windows_mw_pallas``
(the kernel is ``kmers_tpu_torch/csrc/multiword_kernel.cu``).  Output is
in natural order: column ``i`` of the ``(W, n)`` words is the canonical
register of the window that starts at byte ``i``
(``kmers_tpu_torch/convert.py``), :data:`~kmers_tpu_torch.convert.SENTINEL`
in every word where any of its K bytes is not A/C/G/T/U (either case) and
for the last K-1 positions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...convert import n_words
from ..multiword import canonical_windows_mw_bytes
from . import _build

__all__ = ["canonical_words", "canonical_words_plain"]

#: the K range of the kernel, as of the TPU kernel
K_MIN, K_MAX = 32, 63


def _check_k(K: int) -> None:
    if not K_MIN <= K <= K_MAX:
        raise ValueError(
            f"multi-word canonical windows support {K_MIN} <= K <= {K_MAX} (got K={K})"
        )


def canonical_words_plain(bytes_u8: torch.Tensor, K: int):
    """Plain torch version of :func:`canonical_words`, on any device."""
    _check_k(K)
    return canonical_windows_mw_bytes(bytes_u8, K)


@functools.cache
def _kernel():
    v = ctypes.c_void_p
    return _build.kernel(
        "k3_canonical_windows_mw", (v, ctypes.c_longlong, ctypes.c_int, v, v, v)
    )


def canonical_words(bytes_u8: torch.Tensor, K: int):
    """Canonical K-window registers of a 1-D contiguous ``uint8`` tensor,
    as words.

    Returns ``(words, n_invalid, n_ambig)``: ``words`` int64 of shape
    ``(n_words(K), len)``, and 0-d int64 tensors counting the invalid and
    the ambiguous bytes (each byte once).  A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`canonical_words_plain`.
    """
    _check_k(K)
    if bytes_u8.dtype != torch.uint8 or bytes_u8.dim() != 1:
        raise TypeError("canonical_words takes a 1-D uint8 tensor")
    if bytes_u8.device.type == "cpu":
        return canonical_words_plain(bytes_u8, K)
    if bytes_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {bytes_u8.device}")
    if not bytes_u8.is_contiguous():
        raise ValueError("canonical_words takes a contiguous tensor")
    n = bytes_u8.shape[0]
    words = torch.empty((n_words(K), n), dtype=torch.int64, device=bytes_u8.device)
    counters = torch.zeros(2, dtype=torch.int64, device=bytes_u8.device)
    if n:
        with torch.cuda.device(bytes_u8.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _kernel()(
                bytes_u8.data_ptr(), n, K, words.data_ptr(), counters.data_ptr(),
                stream,
            )
        _build.check(code, "k3_canonical_windows_mw")
        canonical_words.launches += 1
    return words, counters[0], counters[1]


#: kernel launches in this process (the wrapper adds one per launch)
canonical_words.launches = 0
