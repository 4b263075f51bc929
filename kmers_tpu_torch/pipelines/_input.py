"""Input and device resolution shared by the pipelines: ASCII bytes to a
uint8 array, CSR records joined with ``N``, the explicit device, the
upload of a byte array and the download of a result."""

from __future__ import annotations

import numpy as np
import torch

from ..alphabets import DNAAlphabet2
from ..utils.profiling import annotate, count

#: the alphabet the pipelines' ``EncodeError`` carries, as in the reference
ALPHABET = DNAAlphabet2()

#: the smallest result :func:`download` pins: below ~1 MiB a copy costs its latency, not its bytes
PINNED_MIN_BYTES = 1 << 20


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
    """A uint8 host array as a tensor on ``device`` (one copy): span
    ``kmers.upload``, counter ``upload_bytes``."""
    with annotate("kmers.upload"):
        count("upload_bytes", arr.nbytes)
        return torch.tensor(arr, dtype=torch.uint8, device=device)


def download(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array (one copy): span
    ``kmers.download``, counter ``download_bytes``.

    A CUDA tensor of at least :data:`PINNED_MIN_BYTES` is copied into
    pinned host memory from torch's caching host allocator (counter
    ``download_pinned_bytes``), so the copy runs at the DMA rate and a
    block freed by an earlier result is reused; the array keeps that
    block until it is freed, then the block returns to the cache.  Smaller
    results, CPU tensors and a pinned allocation that fails take
    ``t.cpu()``."""
    with annotate("kmers.download"):
        arr = _download_pinned(t) if t.is_cuda and t.nbytes >= PINNED_MIN_BYTES else None
        if arr is None:
            arr = t.cpu().numpy()
        count("download_bytes", arr.nbytes)
    return arr


def _download_pinned(t: torch.Tensor) -> np.ndarray | None:
    """``t`` copied into a pinned host tensor (the copy waits for the
    stream, so the values are complete), as numpy; None if the pinned
    allocation fails."""
    try:
        host = torch.empty_like(t, device="cpu", pin_memory=True)
    except RuntimeError:  # too large to pin on this host: the pageable copy
        return None
    host.copy_(t)
    count("download_pinned_bytes", host.nbytes)
    return host.numpy()


def join_records_with_n(seq_bytes, offsets) -> np.ndarray:
    """Join CSR records with single ``N`` separators, so that no window
    spans two records in a skip-ambiguous pipeline (span ``kmers.join``)."""
    with annotate("kmers.join"):
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
