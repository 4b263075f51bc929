"""Input and device resolution shared by the pipelines: ASCII bytes to a
uint8 array, CSR records joined with ``N``, the explicit device, and the
host boundary: every upload of an input and every download of a result
passes :func:`upload`, :func:`download` or :func:`download_table`."""

from __future__ import annotations

import numpy as np
import torch

from ..alphabets import DNAAlphabet2
from ..io.fasta import join_records_native
from ..utils.profiling import annotate, count, pinned_empty_like

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
    """A host array as a tensor of its dtype on ``device`` (one copy): span
    ``kmers.upload``, counter ``upload_bytes``."""
    with annotate("kmers.upload"):
        count("upload_bytes", arr.nbytes)
        return torch.tensor(arr, device=device)


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


def download_table(keys: torch.Tensor, counts: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A device count table as the user's arrays, keys first: int64 keys
    ``(n,)`` as ``np.uint64`` ``(n,)``, int64 word planes ``(W, n)`` as
    ``np.uint64`` rows ``(n, W)``; counts as they are.  Callers pass real
    rows only: real keys and words are non-negative, so their int64 bits
    are the unsigned values."""
    if keys.dim() > 1:
        keys = keys.T.contiguous()
    return download(keys).view(np.uint64), download(counts)


def real_rows(keys: torch.Tensor, counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A folded table cut on the device to its real rows (count > 0), so
    that only they cross to the host (span ``kmers.rows``).  ``keys`` is
    ``(n,)`` or ``(W, n)``."""
    with annotate("kmers.rows"):
        keep = counts > 0
        return keys[..., keep], counts[keep]


def _download_pinned(t: torch.Tensor) -> np.ndarray | None:
    """``t`` copied into a pinned host tensor (``pinned_empty_like``, span
    ``kmers.pin``; the copy waits for the stream, so the values are
    complete), as numpy; None if the pinned allocation fails."""
    try:
        host = pinned_empty_like(t)
    except RuntimeError:  # too large to pin on this host: the pageable copy
        return None
    host.copy_(t)
    count("download_pinned_bytes", host.nbytes)
    return host.numpy()


def join_records_with_n(seq_bytes, offsets) -> np.ndarray:
    """Join CSR records with single ``N`` separators, so that no window
    spans two records in a skip-ambiguous pipeline (span ``kmers.join``).

    The native join places the records (counter ``join_native_records``);
    without the native library, or for offsets that are not CSR, a Python
    loop does."""
    with annotate("kmers.join"):
        offsets = np.asarray(offsets)
        seq = np.asarray(seq_bytes, dtype=np.uint8)
        n_rec = offsets.shape[0] - 1
        if n_rec <= 1:
            return seq
        joined = join_records_native(seq, offsets)
        if joined is not None:
            count("join_native_records", n_rec)
            return joined
        joined = np.full(seq.shape[0] + n_rec - 1, ord("N"), dtype=np.uint8)
        pos = 0
        for i in range(n_rec):
            r = seq[offsets[i] : offsets[i + 1]]
            joined[pos : pos + r.shape[0]] = r
            pos += r.shape[0] + 1
        return joined
