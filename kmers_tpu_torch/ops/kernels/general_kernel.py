"""K6, window registers over a general code stream (2, 4 or 8 bits a
symbol, forward or canonical): its wrapper and its plain version.

Counterpart of ``kmers_tpu/ops/pallas/general_kernel.py::windows_pallas_general``
(the kernel is ``kmers_tpu_torch/csrc/general_kernel.cu``).  Output is in
natural order (the TPU kernel's is offset-major): ``out[i]`` is the
register of the window ``[i, i + K)``, first symbol in the highest bits,
and :data:`~kmers_tpu_torch.convert.SENTINEL` where any of its symbols has
``good == False`` and for the last K-1 positions.  Canonical mode takes the
unsigned minimum of the forward and reverse-complement registers, at 2 and
4 bits only.  Since ``1 <= K * bps <= 62``, no register reaches the
sentinel.

Precondition, as in the JAX package (``pack_words`` does not mask): every
code is below ``2^bps``.

At K = 32 and 2 bits a register fills 64 bits and no value is left for the
sentinel, so :func:`windows_k32`, the K = 32 instance of the same kernel
(the port's counterpart of ``kmers_tpu/ops/pallas/window_kernel.py::canonical_windows_pallas``
at K = 32, kernel K8b), returns the unmasked registers and a separate
validity plane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...convert import SENTINEL
from ..windows import (
    canonical_windows_4bit_from_codes,
    canonical_windows_from_codes,
    window_valid_mask,
    windows_from_codes,
)
from . import _build

__all__ = ["windows_general", "windows_general_plain", "windows_k32", "windows_k32_plain"]


def _check(K: int, bps: int, canonical: bool) -> None:
    if bps not in (2, 4, 8):
        raise ValueError("bps must be 2, 4, or 8")
    if canonical and bps == 8:
        raise ValueError("canonical selection requires a nucleotide width")
    if not (K >= 1 and K * bps <= 62):
        raise ValueError(f"need 1 <= K*bps <= 62 (sentinel headroom; got K={K}, bps={bps})")


def windows_general_plain(
    codes: torch.Tensor, good: torch.Tensor, K: int, bps: int = 2, canonical: bool = False
) -> torch.Tensor:
    """Plain torch version of :func:`windows_general`, on any device and
    any integer code dtype."""
    _check(K, bps, canonical)
    if canonical and bps == 2:
        win = canonical_windows_from_codes(codes, K)
    elif canonical:
        win = canonical_windows_4bit_from_codes(codes, K)
    else:
        win = windows_from_codes(codes, K, bps)
    out = torch.full((codes.shape[0],), SENTINEL, dtype=torch.int64, device=codes.device)
    valid = window_valid_mask(good.to(torch.bool), K)
    out[: win.shape[0]] = torch.where(valid, win, SENTINEL)
    return out


def _on_cuda(codes: torch.Tensor, good: torch.Tensor, name: str) -> bool:
    """Check a wrapper's codes and mask; True when they lie on a CUDA device
    (launch the kernel), False on the CPU (take the plain version)."""
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise TypeError(f"{name} takes 1-D uint8 codes")
    if good.dtype != torch.bool or good.shape != codes.shape:
        raise TypeError(f"{name} takes a bool mask of the codes' shape")
    if codes.device != good.device:
        raise ValueError("codes and mask must be on one device")
    if codes.device.type == "cpu":
        return False
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if not (codes.is_contiguous() and good.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


@functools.cache
def _kernel():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("k6_general_windows", (v, v, ctypes.c_longlong, i, i, i, v, v))


def windows_general(
    codes: torch.Tensor, good: torch.Tensor, K: int, bps: int = 2, canonical: bool = False
) -> torch.Tensor:
    """K-window registers of a code stream: ``codes`` a 1-D ``uint8``
    tensor (each code below ``2^bps``), ``good`` a ``bool`` tensor of the
    same length.  Returns int64 of the input's length.  A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`windows_general_plain`.
    """
    _check(K, bps, canonical)
    if not _on_cuda(codes, good, "windows_general"):
        return windows_general_plain(codes, good, K, bps, canonical)
    n = codes.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=codes.device)
    if n:
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _kernel()(
                codes.data_ptr(), good.data_ptr(), n, K, bps, int(canonical),
                out.data_ptr(), stream,
            )
        _build.check(code, "k6_general_windows")
        windows_general.launches += 1
    return out


#: kernel launches in this process (the wrapper adds one per launch)
windows_general.launches = 0


def windows_k32_plain(codes: torch.Tensor, good: torch.Tensor, canonical: bool = False):
    """Plain torch version of :func:`windows_k32`, on any device."""
    L = codes.shape[0]
    win = (canonical_windows_from_codes if canonical else windows_from_codes)(codes, 32)
    n = win.shape[0]
    out = torch.zeros(L, dtype=torch.int64, device=codes.device)
    valid = torch.zeros(L, dtype=torch.bool, device=codes.device)
    out[:n] = win
    valid[:n] = window_valid_mask(good.to(torch.bool), 32)
    return out, valid


@functools.cache
def _k32_kernel():
    v = ctypes.c_void_p
    return _build.kernel("k8b_windows_k32", (v, v, ctypes.c_longlong, ctypes.c_int, v, v, v))


def windows_k32(codes: torch.Tensor, good: torch.Tensor, canonical: bool = False):
    """32-mer registers of a 2-bit code stream: ``codes`` a 1-D ``uint8``
    tensor (each code below 4), ``good`` a ``bool`` tensor of the same
    length.  Returns ``(registers, valid)`` of the input's length:
    ``registers`` int64, the forward or canonical (unsigned minimum)
    register of every window ``[i, i + 32)`` as a 64-bit pattern, unmasked,
    0 at the last 31 positions; ``valid`` bool, all 32 symbols good.  A CUDA
    tensor launches the kernel; a CPU tensor takes :func:`windows_k32_plain`.
    """
    if not _on_cuda(codes, good, "windows_k32"):
        return windows_k32_plain(codes, good, canonical)
    n = codes.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=codes.device)
    valid = torch.empty(n, dtype=torch.bool, device=codes.device)
    if n:
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _k32_kernel()(
                codes.data_ptr(), good.data_ptr(), n, int(canonical), out.data_ptr(),
                valid.data_ptr(), stream,
            )
        _build.check(code, "k8b_windows_k32")
        windows_k32.launches += 1
    return out, valid


#: kernel launches in this process (the wrapper adds one per launch)
windows_k32.launches = 0
