"""K2, unit-weight run-length encoding of a sorted key stream: its wrapper
and its plain version.

Counterpart of ``kmers_tpu/ops/pallas/rle_kernel.py::rle_unit_pallas`` (the
kernel is ``kmers_tpu_torch/csrc/rle_kernel.cu``), with the same
sentinel-interspersed contract as ``kmers_tpu/ops/count.py::_run_length_encode``:
the last slot of each run keeps its key and the run's length; every other
slot, and the run of sentinels, holds the sentinel and count 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...convert import SENTINEL
from . import _build

__all__ = ["rle_unit", "rle_unit_plain"]


def rle_unit_plain(sorted_keys: torch.Tensor):
    """Plain torch version of :func:`rle_unit`, on any device: the run
    that ends at ``i`` starts at the first index holding ``keys[i]``."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = sorted_keys[1:] != sorted_keys[:-1]
    emit = last & (sorted_keys != SENTINEL)
    start = torch.searchsorted(sorted_keys, sorted_keys)
    length = torch.arange(n, dtype=torch.int64, device=dev) - start + 1
    uniq = torch.where(emit, sorted_keys, SENTINEL)
    counts = torch.where(emit, length, 0)
    return uniq, counts, emit.sum()


@functools.cache
def _kernel():
    v = ctypes.c_void_p
    return _build.kernel("k2_rle_unit", (v, ctypes.c_longlong, v, v, v, v))


def rle_unit(sorted_keys: torch.Tensor):
    """Unit-weight RLE of an ascending 1-D int64 tensor.

    Returns ``(uniq, counts, n_unique)``: int64 tensors of the input's
    length and a 0-d int64 count of the emitted runs.  A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`rle_unit_plain`.
    """
    if sorted_keys.dtype != torch.int64 or sorted_keys.dim() != 1:
        raise TypeError("rle_unit takes a 1-D int64 tensor")
    if sorted_keys.device.type == "cpu":
        return rle_unit_plain(sorted_keys)
    if sorted_keys.device.type != "cuda":
        raise ValueError(f"unsupported device {sorted_keys.device}")
    if not sorted_keys.is_contiguous():
        raise ValueError("rle_unit takes a contiguous tensor")
    n = sorted_keys.shape[0]
    uniq = torch.empty_like(sorted_keys)
    counts = torch.empty_like(sorted_keys)
    n_unique = torch.zeros(1, dtype=torch.int64, device=sorted_keys.device)
    if n:
        with torch.cuda.device(sorted_keys.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _kernel()(
                sorted_keys.data_ptr(), n, uniq.data_ptr(), counts.data_ptr(),
                n_unique.data_ptr(), stream,
            )
        _build.check(code, "k2_rle_unit")
        rle_unit.launches += 1
    return uniq, counts, n_unique[0]


#: kernel launches in this process (the wrapper adds one per launch)
rle_unit.launches = 0
