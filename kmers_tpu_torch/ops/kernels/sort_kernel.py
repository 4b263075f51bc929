"""K11, the sort of int64 keys: its wrappers and their plain versions.

Counterpart of ``kmers_tpu/ops/pallas/sort_kernel.py`` (the kernels are
``kmers_tpu_torch/csrc/sort_kernel.cu``):

- :func:`bitonic_local_sort` sorts every tile of ``tile`` keys, the
  direction following the key's global position (``(pos >> k) & 1``, as on
  the TPU), so consecutive tiles come out ascending, descending, ascending,
  ... (``bitonic_local_sort_pallas``);
- :func:`bitonic_sort` sorts the keys ascending (``bitonic_sort_pallas``).

On the card a sort is bound by device memory (16 bytes a key: read once,
written once).  The tile kernel sorts a block's tile in registers (warp
shuffles for the middle strides, shared memory only for the largest), so
the local pass is one read and one write of the keys.  The full sort is
that kernel with every tile ascending, then ``log2(n / tile)`` merge-path
rounds (the merge of K9, keys only), each one more read and write, from one
buffer into the other (:func:`sort_plan`).

Keys are the port's: a 1-D int64 tensor in signed order (a JAX ``(hi, lo)``
u32 pair maps to a key by ``convert.hashes_from_jax``, which keeps the
unsigned pair order).  The error contracts are the JAX package's: the local
pass needs a length that is a multiple of the tile, the full sort one that
is also a power of two.  The TPU's tile is ``8 W`` pairs (32,768 at its
default ``W = 4096``); the port's tile is a power of two of at most
:data:`MAX_TILE` keys, one block, with :data:`DEFAULT_TILE` the default.
The full sort's output does not depend on the tile (its tile kernel takes
:data:`DEFAULT_TILE` keys, or the whole input if that is shorter); the local
pass's does.

No default path calls K11: the counting pipelines sort with ``torch.sort``,
as the JAX package sorts with ``lax.sort``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .merge_kernel import MERGE_TILE

__all__ = [
    "DEFAULT_TILE",
    "MAX_TILE",
    "bitonic_local_sort",
    "bitonic_local_sort_plain",
    "bitonic_sort",
    "bitonic_sort_plain",
    "sort_plan",
]

#: keys a block sorts by default: 512 threads of 16 registers (64 KB of
#: shared memory for the exchanges); the full sort's tile
DEFAULT_TILE = 8192
#: the largest tile: 512 threads of 32 (128 KB; ``kMaxTile`` of the kernel)
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


def sort_plan(n: int) -> tuple[int, int, int]:
    """How the kernel sorts ``n`` keys (a power of two, or 0): ``(tile,
    rounds, partitions)``.  The tile kernel sorts tiles of ``tile`` keys
    ascending into the first buffer; ``rounds`` merge rounds follow, round r
    merging runs of ``tile << r`` keys pairwise into the other buffer, so
    the result lies in buffer ``rounds % 2``; each round takes
    ``partitions`` co-ranks of scratch (one a merge tile of
    :data:`~kmers_tpu_torch.ops.kernels.merge_kernel.MERGE_TILE` outputs).
    """
    if n < 0 or n & (n - 1):
        raise ValueError(f"length {n} must be a power of two")
    tile = min(DEFAULT_TILE, max(n, 1))
    rounds = (n // tile).bit_length() - 1 if n else 0
    return tile, rounds, (n // MERGE_TILE if rounds else 0)


@functools.cache
def _tile_kernel():
    v = ctypes.c_void_p
    return _build.kernel(
        "k11_tile_sort", (v, v, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, v)
    )


@functools.cache
def _rounds_kernel():
    v = ctypes.c_void_p
    ll = ctypes.c_longlong
    return _build.kernel("k11_merge_rounds", (v, v, ll, ll, ctypes.c_int, v, ll, v))


def _on_cuda(keys: torch.Tensor) -> bool:
    if keys.device.type == "cpu":
        return False
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("the bitonic sort takes a contiguous tensor")
    return True


def _tile_sort(keys: torch.Tensor, tile: int, all_ascending: bool) -> torch.Tensor:
    """Launch the tile kernel on a non-empty CUDA tensor; a new tensor.
    Counts in ``bitonic_local_sort.launches``, the tile kernel's count."""
    out = torch.empty_like(keys)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _tile_kernel()(
            keys.data_ptr(), out.data_ptr(), keys.shape[0], tile, int(all_ascending), stream
        )
    _build.check(code, "k11_tile_sort")
    bitonic_local_sort.launches += 1
    return out


def bitonic_local_sort(keys: torch.Tensor, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Sort every tile of ``tile`` consecutive keys of a 1-D int64 tensor
    whose length is a multiple of ``tile``: ascending for even tiles,
    descending for odd ones.  Returns a new tensor.  A CUDA tensor
    launches the tile kernel; a CPU tensor takes
    :func:`bitonic_local_sort_plain`.
    """
    _check(keys, tile, full=False)
    if not _on_cuda(keys):
        return bitonic_local_sort_plain(keys, tile)
    if keys.shape[0] == 0:
        return torch.empty_like(keys)
    return _tile_sort(keys, tile, all_ascending=False)


def bitonic_sort(keys: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """Sort a 1-D int64 tensor ascending; its length must be a power of two
    and a multiple of ``tile`` (by default :data:`DEFAULT_TILE`, or the
    length if that is shorter).  Returns a new tensor.  A CUDA tensor
    launches the tile kernel with every tile ascending, then the merge
    rounds of :func:`sort_plan` (the result does not depend on ``tile``); a
    CPU tensor takes :func:`bitonic_sort_plain`.
    """
    tile = _default_tile(keys, tile)
    _check(keys, tile, full=True)
    if not _on_cuda(keys):
        return bitonic_sort_plain(keys, tile)
    n = keys.shape[0]
    if n == 0:
        return torch.empty_like(keys)
    sort_tile, rounds, partitions = sort_plan(n)
    bufs = [_tile_sort(keys, sort_tile, all_ascending=True)]
    if rounds:
        bufs.append(torch.empty_like(keys))
        scratch = torch.empty(partitions, dtype=torch.int64, device=keys.device)
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _rounds_kernel()(
                bufs[0].data_ptr(), bufs[1].data_ptr(), n, sort_tile, rounds,
                scratch.data_ptr(), partitions, stream,
            )
        _build.check(code, "k11_merge_rounds")
        bitonic_sort.launches += 1
    return bufs[rounds % 2]


#: wrapper calls in this process that launched their kernels: the tile
#: kernel counts in ``bitonic_local_sort`` (also when the full sort launches
#: it); ``bitonic_sort`` counts its merge rounds, one per call, however many
#: launches they take
bitonic_local_sort.launches = 0
bitonic_sort.launches = 0
