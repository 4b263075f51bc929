"""K12, the minimizer selection of a walk's chunks over K6's registers: its
wrapper and its plain version.

:class:`ChunkMinimizers` takes the chunks of one walk in order
(``pipelines/extract.py::minimizer_select``) and returns each chunk's kept
``(value, position)`` rows: per window of ``W`` registers the one of the
smallest FxHash, leftmost on ties, dropped where it repeats the pick of the
window before (across a seam too), positions shifted by the chunk's first
window.  With ``skip_ambiguous`` a register that is no candidate (K6's
:data:`~kmers_tpu_torch.convert.SENTINEL`, or ``valid == False``) is never
picked and a window without a candidate selects nothing.

The route depends on the input alone:

- K12 (``kmers_tpu_torch/csrc/minimizer_kernel.cu``) for CUDA registers
  that carry the sentinel (K6's, ``1 <= 2K <= 62``) and ``W <=``
  :data:`MAX_W`: one launch a chunk does the FxHash, the sliding minimum,
  the repeat drop and the compaction into a reused, chunk-sized pair of
  row planes; the chunk's row count is read once (span ``kmers.wait``) and
  its rows are copied out, so no chunk's planes outlive it.  It replaces no
  TPU kernel: the JAX package selects minimizers in plain ``jnp``.
- The plain route otherwise (CPU tensors; K = 32, whose registers fill 64
  bits and come with a validity plane; ``W`` above the cap):
  ``ops/minimizer.py``'s doubling sliding minimum (span ``kmers.minimum``),
  the repeat drop, ``torch.nonzero`` (span ``kmers.wait``) and two gathers.

Counters: ``minimizer_kernel_windows``, the windows K12 took (0 on the
plain route); ``minimum_rows``, the rows the sliding minimum writes: on
K12's route the rows it keeps, added once the chunk's count is read, on the
plain route every combine's rows (``ops/minimizer.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.profiling import annotate, count
from ..minimizer import minimizers, minimizers_masked
from . import _build

__all__ = ["MAX_W", "ChunkMinimizers"]

#: the widest window K12 takes (its tile's 16-bit staged indices); minimap2
#: keeps w below 256
MAX_W = 256


@functools.cache
def _kernel():
    v, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.kernel("k12_select_minimizers", (v, ll, i, i, ll, v, v, v, v, v, ll, v))


@functools.cache
def _tile() -> int:
    """Windows a block of K12 owns, from the kernel source that owns the
    tile size."""
    fn = _build.library().k12_tile
    fn.restype = ctypes.c_int
    return fn()


class ChunkMinimizers:
    """The kept minimizer rows of one walk's chunks, taken in order.

    ``W`` k-mers a window; ``sentinel``: the chunks' registers carry the
    sentinel where a window is not valid (K6's); ``windows``: the most
    windows a chunk has; ``device``: the registers' device.  Call it on
    each chunk in turn.
    """

    #: K12 launches in this process (one a chunk on its route)
    launches = 0

    def __init__(self, W: int, skip_ambiguous: bool, sentinel: bool, windows: int, device):
        self.W, self.skip = W, skip_ambiguous
        self.kernel = torch.device(device).type == "cuda" and sentinel and W <= MAX_W
        if self.kernel:
            self.rows = torch.empty((2, windows), dtype=torch.int64, device=device)
            # two carried picks (a chunk reads one and writes the other), the
            # count, the ticket and the tiles' status words
            self.work = torch.full((4 + -(-windows // _tile()),), -1, dtype=torch.int64,
                                   device=device)
            self.chunks = 0
        else:
            # the pick of the window before the next chunk's first (-1: none)
            self.prev = torch.full((1,), -1, dtype=torch.int64, device=device)

    def __call__(self, win: torch.Tensor, valid: torch.Tensor, shift: int):
        """``(values, positions)``, int64: the kept rows of the chunk whose
        registers are ``win`` (``win.shape[0] - W + 1`` windows, the first
        at position ``shift``); ``valid`` the registers that are candidates
        (read on the plain route)."""
        if self.kernel:
            return self._select(win, shift)
        return self._select_plain(win, valid, shift)

    def _select_plain(self, win, valid, shift):
        count("minimizer_kernel_windows", 0)
        with annotate("kmers.minimum"):
            if self.skip:
                kmer, pos = minimizers_masked(win, valid, self.W)
            else:
                kmer, pos = minimizers(win, self.W)
        pos += shift  # a window without a candidate now holds shift - 1
        keep = pos >= shift
        keep[1:] &= pos[1:] != pos[:-1]
        keep[:1] &= pos[:1] != self.prev
        self.prev = pos[-1:].clone()
        with annotate("kmers.wait"):
            idx = torch.nonzero(keep).reshape(-1)
        return kmer[idx], pos[idx]

    def _select(self, win, shift):
        m = win.shape[0] - self.W + 1
        if win.dtype != torch.int64 or win.dim() != 1 or not win.is_contiguous():
            raise TypeError("K12 takes contiguous 1-D int64 registers")
        if win.device != self.rows.device or m > self.rows.shape[1]:
            raise ValueError("a chunk larger than the walk's chunks, or on another device")
        if m < 1:
            return self.rows[0, :0].clone(), self.rows[1, :0].clone()
        count("minimizer_kernel_windows", m)
        tiles = -(-m // _tile())
        work = self.work.data_ptr()
        parity = self.chunks % 2
        self.chunks += 1
        with annotate("kmers.minimum"):
            with torch.cuda.device(win.device):
                stream = torch.cuda.current_stream().cuda_stream
                code = _kernel()(
                    win.data_ptr(), m, self.W, int(self.skip), shift, work + 8 * parity,
                    work + 8 * (1 - parity), self.rows[0].data_ptr(), self.rows[1].data_ptr(),
                    work + 16, tiles, stream,
                )
            _build.check(code, "k12_select_minimizers")
            ChunkMinimizers.launches += 1
        with annotate("kmers.wait"):
            n = int(self.work[2])
        count("minimum_rows", n)
        return self.rows[0, :n].clone(), self.rows[1, :n].clone()
