"""Canonical k-mer counting for K <= 31 — the port's main path.

Counterpart of ``kmers_tpu/pipelines/canonical_count.py``.  The input is
uploaded once; each chunk is a view into it and runs two kernels: K1
(``canonical_windows``: bytes -> canonical int64 window registers and
byte error counts) and ``sort_count`` (``torch.sort``, then K2
``rle_unit``).  Chunk tables are front-packed and folded on the device
through a level stack of merges; rows with ``counts > 0`` are the result.
A CUDA device runs the kernels, a CPU device their plain versions: the
device decides, there is no other switch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kmers_tpu.alphabets import DNAAlphabet2
from kmers_tpu.symbols import EncodeError

from ..convert import SENTINEL
from ..ops.count import compact_counts, merge_compact_tables, sort_count
from ..ops.kernels.window_kernel import canonical_windows
from ..utils.debug import checked_mode
from ..utils.levelstack import LevelStack
from ..utils.streamq import DrainQueue

__all__ = [
    "CountConfig",
    "canonical_count",
    "canonical_count_bytes",
    "canonical_count_records",
    "join_records_with_n",
    "counts_lookup",
    "counts_to_dict",
]


@dataclasses.dataclass(frozen=True)
class CountConfig:
    """Pipeline configuration (the JAX ``CountConfig`` without
    ``use_pallas``: the kernels run if and only if the device is CUDA)."""

    K: int = 31
    #: skip windows containing IUPAC ambiguity codes; if False, an
    #: ambiguity code raises EncodeError
    skip_ambiguous: bool = True
    #: bases per chunk; None = 2^20
    chunk_size: int | None = None

    def __post_init__(self):
        if not 1 <= self.K <= 100:
            raise ValueError(
                "array-plane canonical counting supports 1 <= K <= 100"
            )

    @property
    def resolved_chunk_size(self) -> int:
        """The effective chunk size."""
        return self.chunk_size if self.chunk_size is not None else 1 << 20


def _as_byte_array(data) -> np.ndarray:
    if isinstance(data, str):
        data = data.encode("ascii")
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        raise TypeError("expected ASCII bytes or a uint8 array")
    return arr


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is false"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _count_chunk(chunk: torch.Tensor, K: int, track: bool):
    """One chunk: ``((uniq, counts), scalars)`` with ``scalars`` the int64
    tensor ``[n_unique, n_invalid, n_ambig(, n_valid, n_counted)]``."""
    keys, n_invalid, n_ambig = canonical_windows(chunk, K)
    uniq, counts, n_unique = sort_count(keys, key_bits=2 * K)
    scalars = [n_unique, n_invalid, n_ambig]
    if track:
        scalars += [(keys != SENTINEL).sum(), counts.sum()]
    return (uniq, counts), torch.stack(scalars)


def canonical_count_bytes(
    data, config: CountConfig = CountConfig(), metrics=None, device="cuda"
):
    """Count canonical K-mers of an ASCII nucleotide buffer on ``device``.

    Returns ``(kmers, counts)``: sorted ``np.uint64`` canonical register
    values and their ``np.int64`` counts, as the JAX package returns them.
    Invalid bytes raise EncodeError, and so do ambiguous bases under
    ``skip_ambiguous=False``.  ``metrics``: an optional
    :class:`~kmers_tpu_torch.utils.Metrics` that records one batch.
    """
    if config.K > 31:
        raise NotImplementedError(
            "K > 31 needs multi-limb registers (kernel K3), not ported yet: "
            "ROADMAP.md queue 1 item 10"
        )
    device = _resolve_device(device)
    if metrics is not None:
        metrics.start_batch()
    arr = _as_byte_array(data)
    K = config.K
    chunk_size = config.resolved_chunk_size
    if chunk_size < K:
        raise ValueError(f"chunk_size ({chunk_size}) must be >= K ({K})")
    L = arr.shape[0]
    if L < K:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)

    # consecutive chunks share K-1 bases, so no window is lost at a boundary;
    # each chunk sentinels its own last K-1 windows, so none is counted twice
    step = chunk_size - (K - 1)
    starts = list(range(0, max(L - K + 1, 1), step))
    dbg = checked_mode()
    track = dbg or metrics is not None
    buf = torch.tensor(arr, dtype=torch.uint8, device=device)

    # host-int tallies: [n_invalid, n_ambig, n_valid, n_counted]
    tallies = [0, 0, 0, 0]

    def _merge(a, b):
        return merge_compact_tables(a[0], a[1], b[0], b[1])

    def _slice(out):
        keys, counts, n_unique = out
        nu = int(n_unique)  # the merge's one host round trip
        return keys[:nu], counts[:nu]

    stack = LevelStack(_merge, _slice)

    def _drain(out, values):
        nu = values[0]
        for i, v in enumerate(values[1:]):
            tallies[i] += v
        keys, counts = compact_counts(*out)
        stack.push((keys[:nu], counts[:nu]))

    if len(starts) == 1:
        # one chunk: no compaction, no merge; the final mask drops padding
        acc, scalars = _count_chunk(buf, K, track)
        for i, v in enumerate(scalars.tolist()[1:]):
            tallies[i] += v
    else:
        queue = DrainQueue(_drain)
        for start in starts:
            queue.push(*_count_chunk(buf[start : start + chunk_size], K, track))
        queue.flush()
        acc = stack.fold()

    n_invalid, n_ambig, n_valid, n_counted = tallies
    if n_invalid:
        raise EncodeError(DNAAlphabet2(), "<batch input>")
    if n_ambig and not config.skip_ambiguous:
        raise EncodeError(DNAAlphabet2(), "<ambiguous base>")
    if dbg and n_valid != n_counted:
        raise RuntimeError(
            "checked mode: count conservation violated — "
            f"{n_valid} valid windows but {n_counted} counted (sentinel "
            "collision or kernel bug)"
        )

    # mask on the device, so only real rows cross to the host; real keys
    # are non-negative, so their int64 bits are already the uint64 values
    keep = acc[1] > 0
    kmers = acc[0][keep].cpu().numpy().view(np.uint64)
    counts = acc[1][keep].cpu().numpy()
    if metrics is not None:
        n_windows = max(L - K + 1, 0)
        metrics.end_batch(
            bases_in=L,
            windows_out=n_valid,
            windows_skipped=n_windows - n_valid,
            distinct_kmers=int(kmers.shape[0]),
        )
    return kmers, counts


def canonical_count(data, K: int = 31, skip_ambiguous: bool = True, device="cuda"):
    """Convenience wrapper: ``canonical_count("ACGT...", K)``."""
    return canonical_count_bytes(
        data, CountConfig(K=K, skip_ambiguous=skip_ambiguous), device=device
    )


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


def canonical_count_records(
    seq_bytes, offsets, config: CountConfig = CountConfig(), metrics=None,
    device="cuda",
):
    """Count canonical K-mers over a CSR record batch (e.g. from
    :func:`kmers_tpu.io.read_fastx`); windows never span records.
    Requires ``skip_ambiguous=True``."""
    if not config.skip_ambiguous:
        raise ValueError("record-batch counting requires skip_ambiguous=True")
    return canonical_count_bytes(
        join_records_with_n(seq_bytes, offsets), config, metrics=metrics,
        device=device,
    )


def counts_lookup(kmers: np.ndarray, counts: np.ndarray, queries) -> np.ndarray:
    """Multiplicity of each query kmer in a sorted count table (0 if absent).

    ``queries``: uint64 register values or :class:`Kmer` objects (their
    canonical form is looked up, matching how the table was built).
    """
    from kmers_tpu.kmer import Kmer

    if isinstance(queries, (Kmer, int, np.integer)):
        queries = [queries]
    elif isinstance(queries, np.ndarray) and queries.ndim == 0:
        queries = [queries[()]]
    vals = [
        x.canonical().value if isinstance(x, Kmer) else int(x) for x in queries
    ]
    kmers = np.asarray(kmers)
    q = np.array(vals, dtype=np.uint64)
    idx = np.searchsorted(kmers, q)
    idx_c = np.clip(idx, 0, max(kmers.size - 1, 0))
    hit = (kmers.size > 0) & (kmers[idx_c] == q)
    return np.where(hit, counts[idx_c], 0)


def counts_to_dict(kmers: np.ndarray, counts: np.ndarray, K: int):
    """Materialize a (kmers, counts) table as {Kmer: int}."""
    from kmers_tpu.kmer import Kmer

    A = DNAAlphabet2()
    return {Kmer.unsafe(A, K, int(k)): int(c) for k, c in zip(kmers, counts)}
