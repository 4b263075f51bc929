"""Extraction pipelines: every k-mer, spaced k-mers, minimizers and closed
syncmers of an ASCII nucleotide buffer.

Counterpart of ``kmers_tpu/pipelines/extract.py``.  The window registers
of K <= 31 come from kernel K6 (``windows_general`` at 2 bits: the kernel
on CUDA, its plain version on the CPU), as the reference's TPU route does;
at K = 32 a register fills 64 bits and can equal the sentinel, so K6's
K = 32 instance (``windows_k32``, kernel K8b) gives the registers and a
separate validity mask.  Values are returned as ``np.uint64`` (a K = 32 register's
bit pattern), positions as ``np.int64``.  ``syncmer_select`` is plain torch
on every device, as in the reference.

``minimizer_select`` uploads its input once and walks it in chunks of
:data:`MINIMIZER_CHUNK_WINDOWS` windows, each a view of the device buffer
with its right halo of ``W + K - 2`` bases, so that its device memory is
bounded by the chunk and the result, not by the input.  Each chunk's
registers go to ``ops/kernels/minimizer_kernel.py::ChunkMinimizers``: on
CUDA at K <= 31 and W <= 256 kernel K12 (the FxHash, the sliding minimum,
the repeat drop and the compaction in one launch), otherwise the plain
route of ``ops/minimizer.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import SENTINEL
from ..ops.encode import classify_2bit
from ..ops.hashing import fx_hash_u64
from ..ops.kernels.general_kernel import windows_general, windows_k32
from ..ops.kernels.minimizer_kernel import ChunkMinimizers
from ..ops.minimizer import closed_syncmer_mask
from ..ops.windows import canonical_windows_from_codes, window_valid_mask, windows_from_codes
from ..symbols import EncodeError
from ..utils.profiling import annotate, count
from ._input import ALPHABET, as_byte_array, download, resolve_device, upload

__all__ = ["extract_kmers", "spaced_kmers", "minimizer_select", "syncmer_select"]

#: windows of W k-mers a chunk of ``minimizer_select`` takes.  The path
#: holds ~60-70 bytes a window at its peak (the encode's int64 tensors,
#: K6's registers and K12's two row planes); on an H100, a 48.1-Mb
#: chromosome peaked at 1.36 GB in chunks of 2^24 against 3.23 GB whole,
#: for ~10 % more time a call (2^23: 0.78 GB, +7 %; 2^25: 2.26 GB, +1 %)
MINIMIZER_CHUNK_WINDOWS = 1 << 24


def _upload(data, device):
    return upload(as_byte_array(data), resolve_device(device))


def _windows(buf: torch.Tensor, K: int, canonical: bool):
    """``(windows, valid, counts)`` over the ``L - K + 1`` windows of a
    device byte buffer; ``counts`` the device tensor ``[n_invalid,
    n_ambig]`` of its bytes."""
    codes, certain, ambig = classify_2bit(buf)
    counts = torch.stack([(~(certain | ambig)).sum(), ambig.sum()])
    n = buf.shape[0] - K + 1
    if 1 <= K * 2 <= 62:
        win = windows_general(codes.to(torch.uint8), certain, K, 2, canonical)[:n]
        return win, win != SENTINEL, counts
    if K == 32:
        win, valid = windows_k32(codes.to(torch.uint8), certain, canonical)
        return win[:n], valid[:n], counts
    # other K: the plain windows raise the reference's errors
    windows = canonical_windows_from_codes if canonical else windows_from_codes
    return windows(codes, K), window_valid_mask(certain, K), counts


def _extract(buf: torch.Tensor, K: int, canonical: bool):
    """``(windows, valid, [n_invalid, n_ambig])`` over the ``L - K + 1``
    windows of a device byte buffer; the counts as host ints."""
    win, valid, counts = _windows(buf, K, canonical)
    return win, valid, counts.tolist()


def _values(win: torch.Tensor) -> np.ndarray:
    return download(win).view(np.uint64)


def extract_kmers(data, K: int = 31, canonical: bool = False, skip_ambiguous: bool = True,
                  device="cuda"):
    """All K-mers (K <= 32) of an ASCII buffer as ``(values np.uint64,
    positions np.int64)``.

    With ``skip_ambiguous=False`` any non-ACGT byte raises; otherwise
    windows with an ambiguous base are dropped (invalid bytes still raise).
    """
    buf = _upload(data, device)
    if buf.shape[0] < K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    win, valid, (n_inv, n_amb) = _extract(buf, K, canonical)
    if n_inv:
        raise EncodeError(ALPHABET, "<batch input>")
    if n_amb and not skip_ambiguous:
        raise EncodeError(ALPHABET, "<ambiguous base>")
    pos = torch.nonzero(valid).reshape(-1)
    return _values(win[valid]), download(pos)


def spaced_kmers(data, K: int, J: int, canonical: bool = False, device="cuda"):
    """K-mers sampled at stride J (positions 0, J, 2J, ...); raises on any
    ambiguous base inside a sampled window and on any invalid byte."""
    buf = _upload(data, device)
    if buf.shape[0] < K:
        return np.zeros(0, np.uint64)
    win, valid, (n_inv, _) = _extract(buf, K, canonical)
    # a plain strided slice: the reference's selection matmul
    # (kmers_tpu/ops/stride.py) only works around TPUs serializing them
    vals = win[::J]
    if not bool(valid[::J].all()):
        raise EncodeError(ALPHABET, "<ambiguous base in sampled window>")
    if n_inv:
        raise EncodeError(ALPHABET, "<batch input>")
    return _values(vals)


def syncmer_select(data, K: int = 15, s: int = 5, canonical: bool = False, device="cuda"):
    """Closed-syncmer sampling: the K-mers whose minimal s-mer (by FxHash)
    sits at their first or last offset, as ``(values, positions)``.

    The sampling depends on each K-mer's own content alone; with
    ``canonical=True`` both the K-mers and the s-mers are canonical, so it
    is strand-symmetric.  Needs a buffer of certain bases only.
    """
    if not 1 <= s < K:
        raise ValueError("need 1 <= s < K")
    buf = _upload(data, device)
    if buf.shape[0] < K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    codes, certain, _ = classify_2bit(buf)
    windows = canonical_windows_from_codes if canonical else windows_from_codes
    win = windows(codes, K)
    mask = closed_syncmer_mask(fx_hash_u64(windows(codes, s)), K, s)
    if int((~certain).sum()):
        raise EncodeError(ALPHABET, "<ambiguous or invalid base>")
    pos = torch.nonzero(mask).reshape(-1)
    return _values(win[mask]), download(pos)


def minimizer_select(data, K: int = 15, W: int = 10, canonical: bool = True,
                     skip_ambiguous: bool = False, device="cuda"):
    """(W, K)-minimizers: per window of W consecutive K-mers, the K-mer
    with the smallest FxHash (leftmost on ties); returns the sampling
    without consecutive repeats, as ``(values, positions)``.

    With ``skip_ambiguous=False`` the buffer must hold certain bases only;
    with ``skip_ambiguous=True`` K-mers with an ambiguous base are no
    candidates and a window without a candidate selects nothing.

    The windows are taken :data:`MINIMIZER_CHUNK_WINDOWS` at a time (span
    ``kmers.chunk``): K6 (K8b at K = 32) on the chunk's bases and its right
    halo, then the chunk's selections without repeats, the first one
    compared with the last window before the seam, compacted on the device
    (:class:`~kmers_tpu_torch.ops.kernels.minimizer_kernel.ChunkMinimizers`:
    K12 or the plain route, span ``kmers.minimum``; the read of the chunk's
    row count, span ``kmers.wait``).  The byte classes' counts stay on the
    device until one read a call (span ``kmers.wait``).  Counters:
    ``minimizer_windows`` (the windows evaluated), and ``ChunkMinimizers``'
    ``minimizer_kernel_windows`` and ``minimum_rows``.
    """
    with annotate("kmers.minimizers"):
        buf = _upload(data, device)
        n_win = buf.shape[0] - K - W + 2
        if n_win < 1:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        count("minimizer_windows", n_win)
        halo = W + K - 2
        bad = torch.zeros(2, dtype=torch.int64, device=buf.device)
        select = ChunkMinimizers(W, skip_ambiguous, 1 <= K * 2 <= 62,
                                 min(n_win, MINIMIZER_CHUNK_WINDOWS), buf.device)
        kmers, positions = [], []
        for s in range(0, n_win, MINIMIZER_CHUNK_WINDOWS):
            e = min(s + MINIMIZER_CHUNK_WINDOWS, n_win)
            with annotate("kmers.chunk"):
                win, valid, counts = _windows(buf[s : e + halo], K, canonical)
                bad += counts
                kmer, pos = select(win, valid, s)
                kmers.append(kmer)
                positions.append(pos)
        with annotate("kmers.wait"):
            n_inv, n_amb = bad.tolist()
        if n_inv or (n_amb and not skip_ambiguous):
            raise EncodeError(ALPHABET, "<ambiguous or invalid base>")
        return _values(torch.cat(kmers)), download(torch.cat(positions))
