"""Input and device resolution shared by the pipelines: ASCII bytes to a
uint8 array, CSR records joined with ``N``, the explicit device, and the
upload of a byte array."""

from __future__ import annotations

import numpy as np
import torch

from ..alphabets import DNAAlphabet2

#: the alphabet the pipelines' ``EncodeError`` carries, as in the reference
ALPHABET = DNAAlphabet2()


def as_byte_array(data) -> np.ndarray:
    if isinstance(data, str):
        data = data.encode("ascii")
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        raise TypeError("expected ASCII bytes or a uint8 array")
    return arr


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is false"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint8 host array as a tensor on ``device`` (one copy)."""
    return torch.tensor(arr, dtype=torch.uint8, device=device)


def join_records_with_n(seq_bytes, offsets) -> np.ndarray:
    """Join CSR records with single ``N`` separators, so that no window
    spans two records in a skip-ambiguous pipeline."""
    offsets = np.asarray(offsets)
    seq = np.asarray(seq_bytes, dtype=np.uint8)
    n_rec = offsets.shape[0] - 1
    if n_rec <= 1:
        return seq
    joined = np.full(seq.shape[0] + n_rec - 1, ord("N"), dtype=np.uint8)
    pos = 0
    for i in range(n_rec):
        r = seq[offsets[i] : offsets[i + 1]]
        joined[pos : pos + r.shape[0]] = r
        pos += r.shape[0] + 1
    return joined
