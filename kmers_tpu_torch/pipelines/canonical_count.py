"""Canonical k-mer counting for 1 <= K <= 100 — the port's main path —
and the composition vector built on it.

Counterpart of ``kmers_tpu/pipelines/canonical_count.py``.  The input is
uploaded once; each chunk is a view into it.  Chunk tables are
front-packed and folded on the device through a level stack of merges;
rows with ``counts > 0`` are the result.  A CUDA device runs the kernels,
a CPU device their plain versions: the device decides, there is no other
switch.

- K <= 31: one int64 register per window.  A chunk runs K1
  (``canonical_windows``: bytes -> canonical registers and byte error
  counts) and ``sort_count`` (``torch.sort``, then K2 ``rle_unit``).
- K > 31 (``_count_words``): registers of ``ceil(K / 31)``
  int64 words (``convert.py``).  For 32 <= K <= 63 a chunk runs K3
  (``canonical_words``); for 64 <= K <= 100 its windows are plain torch
  on every device, as the reference computes them with jnp (there is no
  TPU kernel there).  Then ``sort_count_mw``: a lexicographic
  ``torch.sort`` of the words and K2 over their run ids.
  :func:`canonical_count_words` returns such a table as packed words, an
  ``(n, W)`` ``np.uint64`` array; :func:`canonical_count_bytes` boxes
  those rows into Python ints (span ``kmers.words``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..alphabets import DNAAlphabet2
from ..convert import SENTINEL, n_words, words_to_ints
from ..kmer import Kmer
from ..ops.count import merge_compact_tables, sort_count
from ..ops.kernels.multiword_kernel import K_MAX as K3_MAX
from ..ops.kernels.multiword_kernel import canonical_words
from ..ops.kernels.window_kernel import canonical_windows
from ..ops.multiword import canonical_windows_mw_bytes, merge_compact_tables_mw, sort_count_mw
from ..symbols import EncodeError
from ..utils.debug import checked_mode
from ..utils.profiling import annotate
from ._input import ALPHABET, as_byte_array, download_table, join_records_with_n, real_rows, resolve_device, upload
from ._stream import count_stream
from .extract import extract_kmers

__all__ = [
    "CountConfig",
    "canonical_count",
    "canonical_count_bytes",
    "canonical_count_words",
    "canonical_count_records",
    "join_records_with_n",
    "composition_vector",
    "counts_lookup",
    "counts_to_dict",
    "bench",
]

#: the headline metric's single-core CPU baseline (bases/s), as in the
#: JAX package's ``bench`` command
BENCH_BASELINE = 5.0e7


@dataclasses.dataclass(frozen=True)
class CountConfig:
    """Pipeline configuration (the JAX ``CountConfig`` without
    ``use_pallas``: the kernels run if and only if the device is CUDA)."""

    K: int = 31
    #: skip windows containing IUPAC ambiguity codes; if False, an
    #: ambiguity code raises EncodeError
    skip_ambiguous: bool = True
    #: bases per chunk; None = 2^20 for K <= 31, 2^19 for K > 31 (the
    #: reference's defaults)
    chunk_size: int | None = None

    def __post_init__(self):
        if not 1 <= self.K <= 100:
            raise ValueError(
                "array-plane canonical counting supports 1 <= K <= 100"
            )

    @property
    def resolved_chunk_size(self) -> int:
        """The effective chunk size."""
        if self.chunk_size is not None:
            return self.chunk_size
        return (1 << 19) if self.K > 31 else (1 << 20)


def _count_chunk(chunk: torch.Tensor, K: int, track: bool):
    """One K <= 31 chunk: ``((uniq, counts), scalars)`` with ``scalars``
    the int64 tensor ``[n_unique, n_invalid, n_ambig(, n_valid, n_counted)]``.

    The counterpart of the JAX ``_chunk_count`` on both its routes: the
    TPU kernel K7 (``canonical_windows_bytes_flat_pallas``, raw bytes to
    registers in a relabelled order plus byte counters) computes K1's
    function up to a bijective order, so K1 serves it here."""
    keys, n_invalid, n_ambig = canonical_windows(chunk, K)
    uniq, counts, n_unique = sort_count(keys, key_bits=2 * K)
    scalars = [n_unique, n_invalid, n_ambig]
    if track:
        scalars += [(keys != SENTINEL).sum(), counts.sum()]
    return (uniq, counts), torch.stack(scalars)


def _count_chunk_mw(chunk: torch.Tensor, K: int):
    """One K > 31 chunk: ``((uniq, counts), [n_unique, n_invalid, n_ambig])``."""
    # K3 covers the TPU kernel's range; wider registers take plain torch on
    # every device, as the reference takes jnp
    if K <= K3_MAX:
        words, n_invalid, n_ambig = canonical_words(chunk, K)
    else:
        words, n_invalid, n_ambig = canonical_windows_mw_bytes(chunk, K)
    uniq, counts, n_unique = sort_count_mw(words)
    return (uniq, counts), torch.stack([n_unique, n_invalid, n_ambig])


def _check_bytes(n_invalid: int, n_ambig: int, config: CountConfig) -> None:
    if n_invalid:
        raise EncodeError(ALPHABET, "<batch input>")
    if n_ambig and not config.skip_ambiguous:
        raise EncodeError(ALPHABET, "<ambiguous base>")


def _upload(data, config: CountConfig, device):
    """``(buf, chunk_size)``, or None when the input holds no window."""
    arr = as_byte_array(data)
    chunk_size = config.resolved_chunk_size
    if chunk_size < config.K:
        raise ValueError(f"chunk_size ({chunk_size}) must be >= K ({config.K})")
    if arr.shape[0] < config.K:
        return None
    return upload(arr, device), chunk_size


def canonical_count_bytes(
    data, config: CountConfig = CountConfig(), metrics=None, device="cuda"
):
    """Count canonical K-mers of an ASCII nucleotide buffer on ``device``.

    Returns ``(kmers, counts)`` as the JAX package returns them: for
    K <= 31, ``kmers`` is a sorted ``np.uint64`` array of canonical
    register values; for K > 31 a sorted object array of Python-int
    registers (the rows of :func:`canonical_count_words`, boxed);
    ``counts`` is ``np.int64``.  Invalid bytes raise
    EncodeError, and so do ambiguous bases under ``skip_ambiguous=False``.
    ``metrics``: an optional :class:`~kmers_tpu_torch.utils.Metrics` that
    records one batch (K <= 31 only, as in the reference).
    """
    with annotate("kmers.count_bytes"):
        device = resolve_device(device)
        if config.K > 31:
            words, counts = _count_words(data, config, device)
            with annotate("kmers.words"):
                return words_to_ints(words.T), counts
        if metrics is not None:
            metrics.start_batch()
        K = config.K
        up = _upload(data, config, device)
        if up is None:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        buf, chunk_size = up
        dbg = checked_mode()
        track = dbg or metrics is not None
        acc, tallies = count_stream(
            buf, K, chunk_size, lambda c: _count_chunk(c, K, track), merge_compact_tables
        )
        n_invalid, n_ambig, *tracked = tallies
        _check_bytes(n_invalid, n_ambig, config)
        n_valid, n_counted = tracked if track else (0, 0)
        if dbg and n_valid != n_counted:
            raise RuntimeError(
                "checked mode: count conservation violated — "
                f"{n_valid} valid windows but {n_counted} counted (sentinel "
                "collision or kernel bug)"
            )

        kmers, counts = download_table(*real_rows(*acc))
        if metrics is not None:
            n_windows = max(buf.shape[0] - K + 1, 0)
            metrics.end_batch(
                bases_in=buf.shape[0],
                windows_out=n_valid,
                windows_skipped=n_windows - n_valid,
                distinct_kmers=int(kmers.shape[0]),
            )
        return kmers, counts


def canonical_count_words(data, config: CountConfig, device="cuda"):
    """Count canonical K-mers (31 < K <= 100) of an ASCII nucleotide buffer
    on ``device`` and return the table as packed words.

    Returns ``(words, counts)``: ``words`` a C-contiguous ``(n, W)``
    ``np.uint64`` array, ``W = ceil(K / 31)``, each row one register in the
    convention of ``convert.py`` (62-bit words, word 0 the most
    significant), rows in ascending order of the registers; ``counts``
    ``np.int64``.  The same chunk stream and fold as
    :func:`canonical_count_bytes`, which boxes these rows into Python ints;
    errors as there.
    """
    if config.K <= 31:
        raise ValueError(
            f"canonical_count_words takes K > 31 (got K={config.K}); "
            "use canonical_count_bytes"
        )
    with annotate("kmers.count_bytes"):
        return _count_words(data, config, resolve_device(device))


def _count_words(data, config: CountConfig, device):
    """K > 31: multi-word registers, the same chunk stream as K <= 31.
    As in the reference, no metrics batch is recorded and checked mode
    adds no conservation check at these K."""
    K = config.K
    up = _upload(data, config, device)
    if up is None:
        return np.zeros((0, n_words(K)), np.uint64), np.zeros(0, np.int64)
    buf, chunk_size = up
    acc, (n_invalid, n_ambig) = count_stream(
        buf, K, chunk_size, lambda c: _count_chunk_mw(c, K), merge_compact_tables_mw
    )
    _check_bytes(n_invalid, n_ambig, config)
    return download_table(*real_rows(*acc))


def bench_input(L: int = 1 << 26) -> np.ndarray:
    """The bytes :func:`bench` counts: L bytes drawn from ACGT by
    ``np.random.default_rng(0)``, as the JAX CLI's ``bench`` draws them."""
    rng = np.random.default_rng(0)
    return np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, L)]


def bench(L: int = 1 << 26, device="cuda") -> dict:
    """The headline throughput benchmark of the JAX CLI's ``bench``: the
    31-mers of :func:`bench_input`, uploaded once, counted as one chunk
    (K1, ``torch.sort``, K2) once to warm up and then three times, each
    call ended by fetching its distinct count.  Returns the line the CLI
    prints: ``{"metric", "value", "unit", "vs_baseline"}``."""
    K = 31
    device = resolve_device(device)
    buf = upload(bench_input(L), device)
    int(_count_chunk(buf, K, False)[1][0])
    t0 = time.perf_counter()
    for _ in range(3):
        int(_count_chunk(buf, K, False)[1][0])
    dt = (time.perf_counter() - t0) / 3
    return {
        "metric": "canonical_31mer_count_bases_per_sec_per_chip",
        "value": round(L / dt),
        "unit": "bases/sec",
        "vs_baseline": round(L / dt / BENCH_BASELINE, 3),
    }


def canonical_count(data, K: int = 31, skip_ambiguous: bool = True, device="cuda"):
    """Convenience wrapper: ``canonical_count("ACGT...", K)``."""
    return canonical_count_bytes(
        data, CountConfig(K=K, skip_ambiguous=skip_ambiguous), device=device
    )


def canonical_count_records(
    seq_bytes, offsets, config: CountConfig = CountConfig(), metrics=None,
    device="cuda",
):
    """Count canonical K-mers over a CSR record batch (e.g. from
    :func:`kmers_tpu_torch.io.read_fastx`); windows never span records.
    Requires ``skip_ambiguous=True``."""
    if not config.skip_ambiguous:
        raise ValueError("record-batch counting requires skip_ambiguous=True")
    return canonical_count_bytes(
        join_records_with_n(seq_bytes, offsets), config, metrics=metrics,
        device=device,
    )


def composition_vector(
    data, K: int = 4, canonical: bool = False, skip_ambiguous: bool = True, device="cuda"
) -> np.ndarray:
    """Dense K-mer composition spectrum: a ``(4**K,)`` int64 count vector
    indexed by the K-mer register value (tetranucleotide frequencies and
    the like); 1 <= K <= 12.  Canonical K-mers are counted by
    :func:`canonical_count_bytes`, forward ones extracted by
    :func:`~kmers_tpu_torch.pipelines.extract.extract_kmers`."""
    if not 1 <= K <= 12:
        raise ValueError("composition vectors support 1 <= K <= 12")
    if canonical:
        kmers, counts = canonical_count_bytes(
            data, CountConfig(K=K, skip_ambiguous=skip_ambiguous), device=device
        )
        out = np.zeros(4**K, dtype=np.int64)
        out[kmers.astype(np.int64)] = counts
        return out
    vals, _ = extract_kmers(data, K=K, canonical=False, skip_ambiguous=skip_ambiguous, device=device)
    return np.bincount(vals.astype(np.int64), minlength=4**K).astype(np.int64)


def counts_lookup(kmers: np.ndarray, counts: np.ndarray, queries) -> np.ndarray:
    """Multiplicity of each query kmer in a sorted count table (0 if absent).

    ``queries``: register values or :class:`~kmers_tpu_torch.kmer.Kmer`
    objects (their canonical form is looked up, matching how the table was
    built).
    """
    if isinstance(queries, (Kmer, int, np.integer)):
        queries = [queries]
    elif isinstance(queries, np.ndarray) and queries.ndim == 0:
        queries = [queries[()]]
    vals = [
        x.canonical().value if isinstance(x, Kmer) else int(x) for x in queries
    ]
    kmers = np.asarray(kmers)
    # K > 31 tables are object arrays of Python ints; match their dtype
    q = np.array(vals, dtype=object if kmers.dtype == object else np.uint64)
    idx = np.searchsorted(kmers, q)
    idx_c = np.clip(idx, 0, max(kmers.size - 1, 0))
    hit = (kmers.size > 0) & (kmers[idx_c] == q)
    return np.where(hit, counts[idx_c], 0)


def counts_to_dict(kmers: np.ndarray, counts: np.ndarray, K: int):
    """Materialize a (kmers, counts) table as {Kmer: int}, each key a
    2-bit DNA :class:`~kmers_tpu_torch.kmer.Kmer`."""
    A = DNAAlphabet2()
    return {Kmer.unsafe(A, K, int(k)): int(c) for k, c in zip(kmers, counts)}
