"""Six-frame amino-acid window registers of an ASCII byte stream, in plain
torch: the plain versions of kernels K4 and K5.

Counterpart of ``_aa_stream``, ``_aa_windows_step3(_mw)`` and
``_strand_windows`` in ``kmers_tpu/parallel/sixframe.py``, written with
the identities of ``kmers_tpu/ops/pallas/sixframe_kernel.py`` that make
one forward pass enough:

- the union of one strand's three frames is the set of windows at every
  base anchor ``p``: window ``p`` holds the codons at ``p, p + 3, ...,
  p + 3(K - 1)``, the earliest codon highest;
- the reverse strand's window at forward anchor ``p`` is
  ``sum_k RC_AA[p + 3k] << 8k``, with ``RC_AA[q]`` the amino acid of the
  reverse-complement codon over bases ``[q, q + 3)`` (the high byte of
  ``genetic_codes.sixframe_tbl16``): the earliest reverse codon sits in
  the highest byte and at the largest forward position;
- both strands' windows at ``p`` span the bases ``[p, p + 3K)``, so one
  validity test (all certain: A/C/G/T/U, either case) serves both.

Output is in natural order, ``2n`` windows for ``n`` bytes: the forward
window at anchor ``p`` is column ``p``, the reverse one column ``n + p``.
A window is emitted when it is valid and its anchor lies inside its
strand's bounds ``[lo, hi)`` (``bounds = (fw_lo, fw_hi, rv_lo, rv_hi)``,
the TPU kernel's ownership); every other column, and every anchor past
``n - 3K``, is :data:`~kmers_tpu_torch.convert.SENTINEL`.  Registers are
8 bits an amino acid in the word convention of ``convert.py``: one int64
key for K <= 7, ``n_words(K, 8)`` words for 8 <= K <= 32.
"""

from __future__ import annotations

import torch

from ..convert import SENTINEL, n_words
from ..genetic_codes import GeneticCode, sixframe_tbl16, standard_genetic_code
from .encode import classify_2bit
from .windows import or_field, window_valid_mask

__all__ = ["sixframe_windows_from_bytes", "sixframe_words_from_bytes", "K_MAX"]

#: the widest window, in amino acids (the JAX ``SixFrameCountConfig``'s)
K_MAX = 32


def _dual_aa(bytes_u8: torch.Tensor, code: GeneticCode):
    """``(aa_fw, aa_rv, certain)``: the forward and reverse-complement
    amino acid of the codon at every position (garbage within 2 of the
    end and where a base is not certain) and the per-byte certainty."""
    codes, certain, _ = classify_2bit(bytes_u8)
    n = codes.shape[0]
    pad = torch.zeros(2, dtype=torch.int64, device=codes.device)
    c = torch.cat([codes, pad])
    codons = (c[:n] << 4) | (c[1 : n + 1] << 2) | c[2 : n + 2]
    tbl16 = torch.tensor(sixframe_tbl16(code), dtype=torch.int64, device=codes.device)
    dual = tbl16[codons]
    return dual & 0xFF, dual >> 8, certain


def _emit_masks(certain: torch.Tensor, K: int, bounds):
    """Per-strand emit masks of the ``n - 3K + 1`` anchors (validity and
    ownership) and their total."""
    fw_lo, fw_hi, rv_lo, rv_hi = (int(b) for b in bounds)
    valid = window_valid_mask(certain, 3 * K)
    pos = torch.arange(valid.shape[0], device=certain.device)
    emit_f = valid & (pos >= fw_lo) & (pos < fw_hi)
    emit_r = valid & (pos >= rv_lo) & (pos < rv_hi)
    return emit_f, emit_r, emit_f.sum() + emit_r.sum()


def _check(bytes_u8: torch.Tensor, K: int, lo: int, hi: int) -> None:
    if not lo <= K <= hi:
        raise ValueError(f"these six-frame windows support {lo} <= K <= {hi} (got K={K})")
    if bytes_u8.dtype != torch.uint8 or bytes_u8.dim() != 1:
        raise TypeError("six-frame windows take a 1-D uint8 tensor")


def sixframe_windows_from_bytes(
    bytes_u8: torch.Tensor, K: int, bounds, code: GeneticCode = standard_genetic_code
):
    """Both strands' amino-acid K-window keys (1 <= K <= 7) of an ASCII
    byte tensor: ``(keys, n_valid)``, ``keys`` int64 of shape ``(2n,)``
    and ``n_valid`` the 0-d int64 count of emitted windows."""
    _check(bytes_u8, K, 1, 7)
    aa_f, aa_r, certain = _dual_aa(bytes_u8, code)
    n = bytes_u8.shape[0]
    keys = torch.full((2 * n,), SENTINEL, dtype=torch.int64, device=bytes_u8.device)
    m = n - 3 * K + 1
    if m <= 0:
        return keys, torch.zeros((), dtype=torch.int64, device=bytes_u8.device)
    fw = torch.zeros(m, dtype=torch.int64, device=bytes_u8.device)
    rv = torch.zeros_like(fw)
    for k in range(K):
        fw |= aa_f[3 * k : 3 * k + m] << (8 * (K - 1 - k))
        rv |= aa_r[3 * k : 3 * k + m] << (8 * k)
    emit_f, emit_r, n_valid = _emit_masks(certain, K, bounds)
    keys[:m] = torch.where(emit_f, fw, SENTINEL)
    keys[n : n + m] = torch.where(emit_r, rv, SENTINEL)
    return keys, n_valid


def sixframe_words_from_bytes(
    bytes_u8: torch.Tensor, K: int, bounds, code: GeneticCode = standard_genetic_code
):
    """Both strands' amino-acid K-window registers (8 <= K <= 32) of an
    ASCII byte tensor as words: ``(words, n_valid)``, ``words`` int64 of
    shape ``(n_words(K, 8), 2n)`` with :data:`SENTINEL` in every word of a
    column not emitted."""
    _check(bytes_u8, K, 8, K_MAX)
    aa_f, aa_r, certain = _dual_aa(bytes_u8, code)
    n = bytes_u8.shape[0]
    W = n_words(K, 8)
    words = torch.full((W, 2 * n), SENTINEL, dtype=torch.int64, device=bytes_u8.device)
    m = n - 3 * K + 1
    if m <= 0:
        return words, torch.zeros((), dtype=torch.int64, device=bytes_u8.device)
    fw = [torch.zeros(m, dtype=torch.int64, device=bytes_u8.device) for _ in range(W)]
    rv = [torch.zeros_like(fw[0]) for _ in range(W)]
    for k in range(K):
        or_field(fw, aa_f[3 * k : 3 * k + m], 8 * (K - 1 - k), 8)
        or_field(rv, aa_r[3 * k : 3 * k + m], 8 * k, 8)
    emit_f, emit_r, n_valid = _emit_masks(certain, K, bounds)
    words[:, :m] = torch.where(emit_f, torch.stack(fw), SENTINEL)
    words[:, n : n + m] = torch.where(emit_r, torch.stack(rv), SENTINEL)
    return words, n_valid
