"""K11, the bitonic sort of int64 keys: its wrappers and their plain versions.

Counterpart of ``kmers_tpu/ops/pallas/sort_kernel.py`` (the kernels are
``kmers_tpu_torch/csrc/sort_kernel.cu``):

- :func:`bitonic_local_sort` sorts every tile of ``tile`` keys, the
  direction following the key's global position (``(pos >> k) & 1``, as on
  the TPU), so consecutive tiles come out ascending, descending, ascending,
  ... (``bitonic_local_sort_pallas``);
- :func:`bitonic_sort` sorts the keys ascending: the local pass, then the
  cross-tile stages (``bitonic_sort_pallas``).

Keys are the port's: a 1-D int64 tensor in signed order (a JAX ``(hi, lo)``
u32 pair maps to a key by ``convert.hashes_from_jax``, which keeps the
unsigned pair order).  The error contracts are the JAX package's: the local
pass needs a length that is a multiple of the tile, the full sort one that
is also a power of two.  The TPU's tile is ``8 W`` pairs (32,768 at its
default ``W = 4096``); the port's tile is a power of two of at most
:data:`MAX_TILE` keys, one block's shared memory, with :data:`DEFAULT_TILE`
the default.  The full sort's output does not depend on the tile; the local
pass's does.

No default path calls K11: the counting pipelines sort with ``torch.sort``,
as the JAX package sorts with ``lax.sort``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "DEFAULT_TILE",
    "MAX_TILE",
    "bitonic_local_sort",
    "bitonic_local_sort_plain",
    "bitonic_sort",
    "bitonic_sort_plain",
]

#: keys a block sorts in shared memory by default (64 KB)
DEFAULT_TILE = 8192
#: the largest tile (128 KB of shared memory; ``kMaxTile`` of the kernel)
MAX_TILE = 16384


def _check(keys: torch.Tensor, tile: int, full: bool) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("the bitonic sort takes a 1-D int64 tensor")
    if not (1 <= tile <= MAX_TILE and tile & (tile - 1) == 0):
        raise ValueError(f"tile {tile} must be a power of two of at most {MAX_TILE}")
    n = keys.shape[0]
    if full and (n % tile != 0 or n & (n - 1) != 0):
        raise ValueError(f"length {n} must be a power of two and a multiple of {tile}")
    elif n % tile != 0:
        raise ValueError(f"length {n} must be a multiple of {tile}")


def _default_tile(keys: torch.Tensor, tile: int | None) -> int:
    return min(DEFAULT_TILE, max(keys.shape[0], 1)) if tile is None else tile


def _stages(keys: torch.Tensor, last: int) -> torch.Tensor:
    """Stages 1 .. ``last`` of the bitonic network, with tensor ops: stage
    k's steps of stride ``d = 2^(k-1) .. 1`` order each pair ``(i, i + d)``
    descending where bit k of ``i`` is set."""
    x = keys.clone()
    n = x.shape[0]
    for k in range(1, last + 1):
        for j in range(k - 1, -1, -1):
            d = 1 << j
            pairs = x.view(-1, 2, d)
            top, bot = pairs[:, 0], pairs[:, 1]
            start = torch.arange(0, n, 2 * d, device=x.device)
            desc = ((start >> k) & 1).bool()[:, None]
            lo, hi = torch.minimum(top, bot), torch.maximum(top, bot)
            x = torch.stack([torch.where(desc, hi, lo), torch.where(desc, lo, hi)], 1).reshape(-1)
    return x


def bitonic_local_sort_plain(keys: torch.Tensor, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Plain torch version of :func:`bitonic_local_sort`, on any device: the
    network's stages up to ``log2(tile)`` over the whole array."""
    _check(keys, tile, full=False)
    return _stages(keys, tile.bit_length() - 1)


def bitonic_sort_plain(keys: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """Plain torch version of :func:`bitonic_sort`, on any device: every
    stage of the network."""
    tile = _default_tile(keys, tile)
    _check(keys, tile, full=True)
    return _stages(keys, max(keys.shape[0], 1).bit_length() - 1)


@functools.cache
def _local_kernel():
    v = ctypes.c_void_p
    return _build.kernel("k11_bitonic_local", (v, v, ctypes.c_longlong, ctypes.c_int, v))


@functools.cache
def _merge_kernel():
    v = ctypes.c_void_p
    return _build.kernel("k11_bitonic_merge", (v, ctypes.c_longlong, ctypes.c_int, v))


def _on_cuda(keys: torch.Tensor) -> bool:
    if keys.device.type == "cpu":
        return False
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("the bitonic sort takes a contiguous tensor")
    return True


def bitonic_local_sort(keys: torch.Tensor, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Sort every tile of ``tile`` consecutive keys of a 1-D int64 tensor
    whose length is a multiple of ``tile``: ascending for even tiles,
    descending for odd ones.  Returns a new tensor.  A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`bitonic_local_sort_plain`.
    """
    _check(keys, tile, full=False)
    if not _on_cuda(keys):
        return bitonic_local_sort_plain(keys, tile)
    out = torch.empty_like(keys)
    n = keys.shape[0]
    if n:
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _local_kernel()(keys.data_ptr(), out.data_ptr(), n, tile, stream)
        _build.check(code, "k11_bitonic_local")
        bitonic_local_sort.launches += 1
    return out


def bitonic_sort(keys: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """Sort a 1-D int64 tensor ascending; its length must be a power of two
    and a multiple of ``tile`` (by default :data:`DEFAULT_TILE`, or the
    length if that is shorter).  Returns a new tensor: the local pass
    (:func:`bitonic_local_sort`), then the stages above the tile in place.
    A CUDA tensor launches the kernels; a CPU tensor takes
    :func:`bitonic_sort_plain`.
    """
    tile = _default_tile(keys, tile)
    _check(keys, tile, full=True)
    if not _on_cuda(keys):
        return bitonic_sort_plain(keys, tile)
    out = bitonic_local_sort(keys, tile)
    n = keys.shape[0]
    if n > tile:
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _merge_kernel()(out.data_ptr(), n, tile, stream)
        _build.check(code, "k11_bitonic_merge")
        bitonic_sort.launches += 1
    return out


#: wrapper calls in this process that launched their kernels (the local
#: pass counts in ``bitonic_local_sort``; ``bitonic_sort`` counts its
#: cross-tile stages, one per call, however many launches they take)
bitonic_local_sort.launches = 0
bitonic_sort.launches = 0
