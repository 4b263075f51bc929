"""Batched reverse translation: amino-acid codes -> codon-set bitmasks.

Counterpart of ``kmers_tpu/ops/revtrans_ops.py``: a 27-entry table of the
code's codon-set masks (``revtrans.py``), gathered per amino acid.  A
mask is one int64 bit pattern: its ``.numpy().view(np.uint64)`` is the
JAX package's ``(hi << 32) | lo``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..genetic_codes import GeneticCode, standard_genetic_code
from ..revtrans import N_SETS, codon_set_masks

__all__ = ["codon_set_table", "reverse_translate_codes"]


@functools.lru_cache(maxsize=64)
def codon_set_table(code: GeneticCode = standard_genetic_code, device="cuda") -> torch.Tensor:
    """The code's 27 codon-set masks as an int64 tensor on ``device``, the
    card unless the caller asks for the CPU (cached per code and device)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is false")
    masks = np.array(codon_set_masks(code), dtype=np.uint64).view(np.int64)
    return torch.from_numpy(masks).to(device)


def reverse_translate_codes(aa_codes, code: GeneticCode = standard_genetic_code) -> torch.Tensor:
    """Amino-acid codes (a tensor or array) -> int64 codon-set masks on
    the codes' device.  The gap (code 27), which has no codons, and codes
    outside the alphabet raise ``ValueError``, as in the JAX package."""
    codes = torch.as_tensor(aa_codes).to(torch.int64)
    if ((codes < 0) | (codes >= N_SETS)).any():
        raise ValueError("Cannot reverse translate element: gap/out-of-range")
    return codon_set_table(code, codes.device)[codes]
