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
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import SENTINEL
from ..ops.encode import classify_2bit
from ..ops.hashing import fx_hash_u64
from ..ops.kernels.general_kernel import windows_general, windows_k32
from ..ops.minimizer import closed_syncmer_mask, minimizers, minimizers_masked
from ..ops.windows import canonical_windows_from_codes, window_valid_mask, windows_from_codes
from ..symbols import EncodeError
from ._input import ALPHABET, as_byte_array, download, resolve_device, upload

__all__ = ["extract_kmers", "spaced_kmers", "minimizer_select", "syncmer_select"]


def _upload(data, device):
    return upload(as_byte_array(data), resolve_device(device))


def _extract(buf: torch.Tensor, K: int, canonical: bool):
    """``(windows, valid, [n_invalid, n_ambig])`` over the ``L - K + 1``
    windows of a device byte buffer; the counts as host ints."""
    codes, certain, ambig = classify_2bit(buf)
    counts = torch.stack([(~(certain | ambig)).sum(), ambig.sum()])
    n = buf.shape[0] - K + 1
    if 1 <= K * 2 <= 62:
        win = windows_general(codes.to(torch.uint8), certain, K, 2, canonical)[:n]
        return win, win != SENTINEL, counts.tolist()
    if K == 32:
        win, valid = windows_k32(codes.to(torch.uint8), certain, canonical)
        return win[:n], valid[:n], counts.tolist()
    # other K: the plain windows raise the reference's errors
    windows = canonical_windows_from_codes if canonical else windows_from_codes
    return windows(codes, K), window_valid_mask(certain, K), counts.tolist()


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
    """
    buf = _upload(data, device)
    if buf.shape[0] - K + 1 < W:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    win, valid, (n_inv, n_amb) = _extract(buf, K, canonical)
    if n_inv or (n_amb and not skip_ambiguous):
        raise EncodeError(ALPHABET, "<ambiguous or invalid base>")
    if skip_ambiguous:
        kmer, pos = minimizers_masked(win, valid, W)
    else:
        kmer, pos = minimizers(win, W)
    keep = pos >= 0
    keep[1:] &= pos[1:] != pos[:-1]
    return _values(kmer[keep]), download(pos[keep])
