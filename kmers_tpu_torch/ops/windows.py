"""Canonical window registers over a 2-bit code stream, in plain torch.

Counterparts of ``kmers_tpu/ops/windows.py::canonical_windows_from_codes``
and ``window_valid_mask``, in natural position order: entry ``i`` is the
window of positions ``[i, i + K)``.  These are the building blocks of the
front-end kernel's plain version (``ops/kernels/window_kernel.py``).
"""

from __future__ import annotations

import torch

__all__ = ["canonical_windows_from_codes", "window_valid_mask"]


def canonical_windows_from_codes(codes: torch.Tensor, K: int) -> torch.Tensor:
    """``min(forward, reverse complement)`` register of every K-window of an
    int64 2-bit code stream: ``L - K + 1`` int64 values, first base in the
    highest bits (the scalar ``Kmer`` layout)."""
    if not 1 <= K <= 31:
        raise ValueError("int64 windows support 1 <= K <= 31")
    n = codes.shape[0] - K + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    fw = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fw)
    for j in range(K):
        c = codes[j : j + n]
        fw = (fw << 2) | c
        # base j's complement is base K-1-j of the reverse complement
        rc = rc | ((3 - c) << (2 * j))
    return torch.minimum(fw, rc)


def window_valid_mask(good: torch.Tensor, K: int) -> torch.Tensor:
    """Per-window "all K symbols good" mask of a per-symbol bool tensor:
    ``L - K + 1`` entries."""
    L = good.shape[0]
    n = L - K + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.bool, device=good.device)
    bad = torch.zeros(L + 1, dtype=torch.int64, device=good.device)
    bad[1:] = torch.cumsum((~good).to(torch.int64), 0)
    return (bad[K : L + 1] - bad[0:n]) == 0
