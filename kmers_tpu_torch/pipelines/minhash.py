"""MinHash sketching of canonical k-mers.

Counterpart of ``kmers_tpu/pipelines/minhash.py``: the sketch of a
sequence is the ``s`` smallest distinct seed-0 FxHash values over its
canonical K-mers, a sorted ``np.uint64`` array; sketches merge and compare
with set operations (Mash-style Jaccard estimates).

Hashes are int64 order keys on the device (``convert.py``).  For K <= 31
they come from K1's hash mode (``canonical_hashes``: the kernel on CUDA,
its plain version on the CPU), as the reference's TPU route does; at
K = 32 plain torch computes them on every device, as the reference's jnp
route does (its TPU kernel stops at 31).  Selection is one
``torch.topk`` of the smallest ``min(max(4 s, 64), n_windows)`` keys, then
the distinct values; the sketch is exact when the s-th distinct key lies
strictly below the largest selected key (every key below that one was
selected), and otherwise comes from all the keys (the reference's
full-width fallback, for inputs with many repeated k-mers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import SENTINEL, SIGN_BIT
from ..ops.encode import classify_2bit
from ..ops.hashing import fx_hash_u64
from ..ops.kernels.window_kernel import canonical_hashes
from ..ops.windows import canonical_windows_from_codes, window_valid_mask
from ..symbols import EncodeError
from ..utils.profiling import annotate
from ._input import ALPHABET, as_byte_array, download, join_records_with_n, resolve_device, upload

__all__ = [
    "minhash_sketch",
    "StreamingSketcher",
    "sketch_fastx_stream",
    "jaccard",
]


def _hash_keys(buf: torch.Tensor, K: int):
    """``(keys, n_invalid, n_ambig)``: the hash key of every window of
    ``buf``, :data:`SENTINEL` where invalid."""
    if K <= 31:
        return canonical_hashes(buf, K)
    codes, certain, ambig = classify_2bit(buf)
    keys = fx_hash_u64(canonical_windows_from_codes(codes, K))
    valid = window_valid_mask(certain, K)
    return torch.where(valid, keys, SENTINEL), (~(certain | ambig)).sum(), ambig.sum()


def _smallest(keys: torch.Tensor, prefix: int, s: int):
    """The ``prefix`` smallest keys: their first ``s`` distinct real keys,
    sorted, as an int64 numpy array, and the largest selected key."""
    with annotate("kmers.select"):
        if prefix < keys.shape[0]:
            keys = torch.topk(keys, prefix, largest=False, sorted=False).values
        distinct = torch.unique(keys)
        head = distinct[distinct != SENTINEL][:s]
    head = download(head)
    with annotate("kmers.wait"):
        boundary = int(keys.max())
    return head, boundary


def _sketch_keys(buf: torch.Tensor, K: int, s: int, skip_ambiguous: bool) -> np.ndarray:
    """Exact ``s`` smallest distinct hash keys of the windows of one
    device buffer (``len(buf) >= K``), sorted int64.

    Error contract (that of the counting pipeline): an invalid byte always
    raises ``EncodeError``; an ambiguous base raises only when
    ``skip_ambiguous`` is False."""
    n_windows = buf.shape[0] - K + 1
    with annotate("kmers.hash"):
        keys, n_invalid, n_ambig = _hash_keys(buf, K)
    with annotate("kmers.wait"):
        n_invalid, n_ambig = torch.stack([n_invalid, n_ambig]).tolist()
    if n_invalid:
        raise EncodeError(ALPHABET, "<batch input>")
    if n_ambig and not skip_ambiguous:
        raise EncodeError(ALPHABET, "<ambiguous base>")
    prefix = min(max(4 * s, 64), max(n_windows, 1))
    head, boundary = _smallest(keys, prefix, s)
    exact = (head.size >= s and head[s - 1] < boundary) or prefix >= n_windows
    if not exact:
        # repeated k-mers or a boundary tie: select from every key
        head, _ = _smallest(keys, keys.shape[0], s)
    return head


def _to_hashes(keys: np.ndarray) -> np.ndarray:
    return (keys ^ np.int64(SIGN_BIT)).view(np.uint64)


def minhash_sketch(data, K: int = 16, s: int = 1000, skip_ambiguous: bool = True, device="cuda"):
    """The ``s`` smallest distinct canonical-K-mer FxHashes of ``data``
    (ASCII bytes or str), a sorted ``np.uint64`` array of length <= s.

    Invalid bytes always raise ``EncodeError``; ambiguous IUPAC codes are
    skipped when ``skip_ambiguous`` (the default) and raise otherwise.
    """
    with annotate("kmers.sketch"):
        device = resolve_device(device)
        arr = as_byte_array(data)
        if arr.size < K:
            return np.zeros(0, np.uint64)
        buf = upload(arr, device)
        return _to_hashes(_sketch_keys(buf, K, s, skip_ambiguous))


class StreamingSketcher:
    """Incremental MinHash: push record batches, finalize to the sketch of
    everything pushed.

    The s smallest distinct hashes of A ∪ B are the s smallest of
    sketch(A) ∪ sketch(B), so the running state is one sorted array of at
    most s hashes, and every chunk's sketch is exact: the result equals the
    one-shot sketch of the concatenated input.  Ambiguous bases are
    skipped; invalid bytes raise.  With ``metrics`` (a
    :class:`~kmers_tpu_torch.utils.Metrics`), ``finalize`` records one batch
    as the reference does: bases in, windows out (those inside records when
    ``offsets`` are given), no windows skipped, and the sketch's size.

    >>> sk = StreamingSketcher(K=16, s=1000, device="cpu")
    >>> for seq, off in stream_fastx("reads.fq.gz"):
    ...     sk.update(seq, off)
    >>> sketch = sk.finalize()
    """

    def __init__(self, K: int = 16, s: int = 1000, chunk_size: int = 1 << 24, metrics=None,
                 device="cuda"):
        if chunk_size < K:
            raise ValueError("chunk_size must be >= K")
        self.K, self.s, self.chunk_size = K, s, chunk_size
        self.device = resolve_device(device)
        self._sketch = np.zeros(0, np.uint64)
        self._bases = 0
        self._windows = 0
        self._done = False
        self.metrics = metrics
        if metrics is not None:
            metrics.start_batch()

    def update(self, seq_bytes, offsets=None):
        """Sketch one record batch.  ``offsets`` (int64 CSR record starts,
        as the fastx readers give) joins records with 'N', so that no window
        spans two records."""
        with annotate("kmers.sketch"):
            if self._done:
                raise RuntimeError("finalize() already called")
            arr = as_byte_array(seq_bytes)
            K = self.K
            if offsets is not None:
                # the windows inside each record (none spans an 'N' join)
                lens = np.diff(np.asarray(offsets))
                self._windows += int(np.maximum(lens - K + 1, 0).sum())
                self._bases += int(lens.sum())
                arr = join_records_with_n(arr, offsets)
            else:
                self._bases += arr.shape[0]
                self._windows += max(arr.shape[0] - K + 1, 0)
            L = arr.shape[0]
            if L < K:
                return
            buf = upload(arr, self.device)
            # chunks overlap by K-1 bytes, so each window lies in one chunk
            step = self.chunk_size - (K - 1)
            for start in range(0, L - K + 1, step):
                h = _to_hashes(_sketch_keys(buf[start : start + self.chunk_size], K, self.s, True))
                self._sketch = np.unique(np.concatenate([self._sketch, h]))[: self.s]

    @property
    def bases_seen(self) -> int:
        return self._bases

    def finalize(self) -> np.ndarray:
        self._done = True
        if self.metrics is not None:
            self.metrics.end_batch(
                bases_in=self._bases, windows_out=self._windows, windows_skipped=0,
                distinct_kmers=int(self._sketch.size),
            )
        return self._sketch


def sketch_fastx_stream(path, K: int = 16, s: int = 1000, batch_bytes: int = 1 << 26,
                        chunk_size: int = 1 << 24, device="cuda"):
    """MinHash-sketch a FASTA/FASTQ file without loading it: record
    batches through a :class:`StreamingSketcher`."""
    from ..io import stream_fastx

    sk = StreamingSketcher(K=K, s=s, chunk_size=chunk_size, device=device)
    for seq, off in stream_fastx(path, batch_bytes=batch_bytes):
        sk.update(seq, off)
    return sk.finalize()


def jaccard(sketch_a: np.ndarray, sketch_b: np.ndarray, s: int | None = None):
    """Mash-style Jaccard estimate from two minhash sketches."""
    if s is None:
        s = min(sketch_a.size, sketch_b.size)
    if s == 0:
        return 0.0
    merged = np.union1d(sketch_a, sketch_b)[:s]
    inter = np.intersect1d(sketch_a, sketch_b, assume_unique=True)
    return float(np.isin(merged, inter).sum()) / float(merged.size)
