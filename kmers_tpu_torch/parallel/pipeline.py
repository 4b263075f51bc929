"""Sharded canonical k-mer counting (K <= 31) over a :class:`~.mesh.Mesh`.

Counterpart of ``kmers_tpu/parallel/pipeline.py``, the multi-device
flagship:

1. **Halo sharding** (:func:`_shard_with_halo`): the input is split into
   ``n_dev`` equal slabs, each with a right halo of K - 1 bases and the
   tail padded with ``N`` (the ambiguity class), so every window lies in
   exactly one slab and padding is never an invalid byte.
2. **Local count**: each rank counts its slab with the single-device chunk
   path, ``canonical_count._count_chunk`` (kernel K1, then ``torch.sort``
   and kernel K2).  A slab of one chunk is one dispatch
   (:func:`sharded_count_step`); a longer slab streams through
   ``_stream.count_stream`` in chunks of ``chunk_size`` that overlap by
   K - 1, folded on the device (K10, then K9's merge-reduce a merge:
   ``merge_compact_tables``).
3. **Hash-prefix exchange** (:func:`exchange_and_merge`, once, on the final
   local tables): each real row goes to the rank that owns the top bits of
   its key's FxHash, in fixed buckets of ``cap`` rows over the mesh's
   ``all_to_all``; real rows past ``cap`` are counted as overflow, which
   raises, never dropped quietly.
4. **Merge**: each rank sorts what it received and sums equal keys (the
   weighted ``_run_length_encode``), so every distinct k-mer ends on exactly
   one rank; the ranks' tables are gathered, sorted on the device and
   downloaded once.

The route, the buckets and the merge are plain torch, as the reference
computes them with jnp outside any Pallas kernel.  The decisions are the
reference's: the same routes, capacities and overflow tests, so that its
error contracts hold bit for bit.  The result is deterministic and equal
to single-device counting at any world size.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..convert import SENTINEL, SIGN_BIT
from ..ops.count import _run_length_encode, merge_compact_tables
from ..ops.hashing import fx_hash_u64
from ..pipelines._input import ALPHABET, as_byte_array, download_table
from ..pipelines._stream import count_stream
from ..pipelines.canonical_count import _count_chunk
from ..symbols import EncodeError
from ..utils.debug import checked_mode
from ..utils.profiling import annotate, count
from .mesh import Mesh, data_mesh

__all__ = [
    "ShardedCountConfig",
    "destination",
    "exchange_and_merge",
    "sharded_count_step",
    "sharded_canonical_count",
]

OVERFLOW_MESSAGE = "hash-prefix bucket overflow; increase bucket_factor"


@dataclasses.dataclass(frozen=True)
class ShardedCountConfig:
    """The JAX ``ShardedCountConfig`` without ``use_pallas`` and
    ``pallas_interpret``: as in ``CountConfig``, the device decides."""

    K: int = 31
    #: per-destination bucket capacity as a multiple of the uniform share;
    #: FxHash spreads k-mers near-uniformly, so a small factor suffices.
    #: Overflow is detected and raised, never dropped.
    bucket_factor: float = 2.0
    #: bases a rank counts at a time; longer slabs stream in chunks
    chunk_size: int = 1 << 20

    def __post_init__(self):
        if not 1 <= self.K <= 31:
            raise ValueError("sharded counting supports 1 <= K <= 31")
        if self.chunk_size < self.K:
            raise ValueError("chunk_size must be >= K")


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def destination(hash_keys: torch.Tensor, n_dev: int) -> torch.Tensor:
    """The rank owning each row: the top ``bit_length(n_dev - 1)`` bits of
    the high 32 bits of the row's FxHash, modulo ``n_dev``.  ``hash_keys``
    are order keys (``fx_hash_u64``, ``fx_hash_mw``: the sign bit flipped),
    so the sign bit is flipped back first."""
    hh = ((hash_keys ^ SIGN_BIT) >> 32) & 0xFFFFFFFF
    shift = 32 - max(n_dev - 1, 1).bit_length()
    return (hh >> shift) % n_dev


def _planes(keys: torch.Tensor) -> torch.Tensor:
    """A table's keys as ``(W, n)`` word planes (``(1, n)`` for one word),
    an empty table included."""
    return keys if keys.dim() == 2 else keys[None]


def _route(keys: torch.Tensor, counts: torch.Tensor, hash_keys: torch.Tensor, n_dev: int, cap: int):
    """One rank's buckets: ``(n_dev, cap, W + 1)`` int64 rows of words and
    count, bucket ``d`` holding the real rows bound for rank ``d`` (any
    order) and padding (:data:`SENTINEL` words, count 0) after them; and
    the 0-d count of real rows past ``cap``.

    Padding rows (count 0) are not sent: the reference routes them
    round-robin behind the real rows of each bucket as filler that the
    receiver drops, so the buckets' real rows, and the overflow, are the
    same.
    """
    n = counts.shape[0]
    rows = torch.cat([_planes(keys), counts.reshape(1, n)]).T
    real = counts > 0
    dest = torch.where(real, destination(hash_keys, n_dev), n_dev)
    # rows of one destination become contiguous, padding last
    sdest, order = torch.sort(dest, stable=False)
    per_dest = torch.bincount(dest, minlength=n_dev + 1)[:n_dev]
    starts = torch.cumsum(per_dest, 0) - per_dest
    slot = torch.arange(n, device=keys.device) - starts[sdest.clamp(max=n_dev - 1)]
    keep = (sdest < n_dev) & (slot < cap)
    buckets = torch.zeros((n_dev, cap, rows.shape[1]), dtype=torch.int64, device=keys.device)
    buckets[..., :-1] = SENTINEL
    buckets[sdest[keep], slot[keep]] = rows[order[keep]]
    overflow = (per_dest - cap).clamp(min=0).sum()
    return buckets, overflow


def _merge_one_word(received: torch.Tensor):
    """Sort the received ``(m, 2)`` rows by key and sum equal keys:
    ``(keys, counts, n_unique)``, sentinel-interspersed."""
    skeys, order = torch.sort(received[:, 0], stable=False)
    return _run_length_encode(skeys, received[:, 1][order])


def _exchange(tables: list, mesh: Mesh, cap: int, hash_fn, merge_fn):
    """Route, transport, merge; returns (per local rank ``(keys, counts,
    n_unique)``, the overflow summed over the mesh)."""
    if mesh.size == 1:
        # one rank: its table is already the global table
        return [(k, c, (c > 0).sum()) for k, c in tables], 0
    with annotate("kmers.exchange"):
        routed = [_route(k, c, hash_fn(k), mesh.size, cap) for k, c in tables]
        (overflow,) = mesh.sum([o for _, o in routed])
        received = mesh.all_to_all([b for b, _ in routed])
        del routed
        rows = [r.reshape(-1, r.shape[-1]) for r in received]
        for r in rows:
            # the rows a rank's merge sorts (n_dev x cap), and the real ones
            count("exchange_rows", r.shape[0])
            count("exchange_rows_real", lambda: (r[:, -1] > 0).sum())
        return [merge_fn(r) for r in rows], overflow


def exchange_and_merge(tables: list, mesh: Mesh, cap: int):
    """Route each local rank's ``(keys, counts)`` table (K <= 31, padding
    rows with count 0 anywhere) to the ranks owning its keys' FxHash
    prefixes and merge what each rank receives.

    Returns ``(merged, overflow)``: per local rank ``(keys, counts,
    n_unique)``, a sentinel-interspersed table whose real rows are the
    rank's share of the global table, and the number of real rows that did
    not fit their bucket of ``cap``, summed over the mesh (callers raise on
    > 0).  With one rank the exchange is the identity.
    """
    return _exchange(tables, mesh, cap, fx_hash_u64, _merge_one_word)


def _shard_with_halo(arr: np.ndarray, n_dev: int, K: int, pad_byte: int = 0):
    """Split bases into ``n_dev`` equal shards with K - 1 right halos,
    the tail padded with ``pad_byte``.  Returns ``(rows, shard)``."""
    shard = -(-arr.shape[0] // n_dev)
    return _slabs(arr, n_dev, shard, K - 1, pad_byte), shard


def _slabs(arr: np.ndarray, n_dev: int, shard: int, halo: int, pad_byte: int) -> np.ndarray:
    """Rows ``[d * shard, (d + 1) * shard + halo)`` of ``arr`` padded with
    ``pad_byte``: ``(n_dev, shard + halo)`` uint8, built on the host (span
    ``kmers.slabs``)."""
    with annotate("kmers.slabs"):
        out = np.empty((n_dev, shard + halo), dtype=np.uint8)
        for d in range(n_dev):
            part = arr[d * shard : (d + 1) * shard + halo]
            out[d, : part.shape[0]] = part
            out[d, part.shape[0] :] = pad_byte
        return out


def _real_rows(keys: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The rows with a count of a table, as ``(m, W + 1)`` int64."""
    keep = counts > 0
    return torch.cat([_planes(keys)[:, keep], counts[keep].reshape(1, -1)]).T


def _gather_rows(merged: list, mesh: Mesh) -> torch.Tensor:
    """Every rank's real rows, as one ``(m, W + 1)`` tensor on the device
    of this process's first rank.  Each rank's rows are sorted, and no key
    is on two ranks."""
    with annotate("kmers.gather"):
        return torch.cat(mesh.gather([_real_rows(k, c) for k, c, _ in merged]))


def sharded_count_step(slabs: list, mesh: Mesh, K: int, cap: int, checked: bool = False):
    """Local count of one-chunk slabs and the exchange, for a fixed
    geometry (the single-dispatch route).

    ``slabs``: each local rank's uint8 slab on its device.  Returns
    ``(merged, tallies, overflow)``: the exchanged tables (see
    :func:`exchange_and_merge`), the mesh's sums of ``[n_invalid,
    n_valid, n_counted]`` (the last two 0 unless ``checked``), and the
    overflow.
    """
    tables, tallies = [], []
    for slab in slabs:
        table, scalars = _count_chunk(slab, K, checked)
        tables.append(table)
        # [n_invalid, n_valid, n_counted]; the last two are tracked when checked
        tallies.append(scalars[[1, 3, 4]] if checked else torch.cat([scalars[1:2], scalars.new_zeros(2)]))
    sums = mesh.sum(tallies)
    merged, overflow = exchange_and_merge(tables, mesh, cap)
    return merged, sums, overflow


def _streamed_sharded_count(slabs: list, mesh: Mesh, config: ShardedCountConfig,
                            checked: bool = False):
    """Stream each rank's slab in chunks, fold its tables on the device,
    then exchange the final tables once.  Returns what
    :func:`sharded_count_step` returns."""
    K = config.K
    tables, tallies, distinct = [], [], []
    for slab in slabs:
        table, sums = count_stream(
            slab, K, config.chunk_size, lambda c: _count_chunk(c, K, checked), merge_compact_tables
        )
        tables.append(table)
        n_invalid, _n_ambig, *tracked = sums
        tallies.append([n_invalid, *(tracked if checked else (0, 0))])
        distinct.append((table[1] > 0).sum())
    sums = mesh.sum(tallies)
    # the reference's per-device table width after its fold: the next
    # power of two of the largest rank's distinct count
    (most,) = mesh.max(distinct)
    C = _next_pow2(max(most, 1))
    cap = max(math.ceil(C * config.bucket_factor / mesh.size), 1)
    merged, overflow = exchange_and_merge(tables, mesh, cap)
    return merged, sums, overflow


def sharded_canonical_count(data, config: ShardedCountConfig = ShardedCountConfig(),
                            mesh: Mesh | None = None, metrics=None):
    """Count canonical K-mers (K <= 31) across the ranks of ``mesh``
    (default: :func:`~.mesh.data_mesh`, every GPU).

    Returns ``(kmers, counts)``: sorted ``np.uint64`` k-mers and
    ``np.int64`` counts, on every process of a process-group mesh, equal
    to single-device counting.  Raises ``EncodeError`` on invalid bytes
    (ambiguous bases are skipped) and ``RuntimeError`` on bucket overflow
    (raise ``bucket_factor``).  Checked mode adds both count-conservation
    checks of the reference.  ``metrics``: an optional
    :class:`~kmers_tpu_torch.utils.Metrics` recording one batch.
    """
    with annotate("kmers.sharded_count"):
        if metrics is not None:
            metrics.start_batch()
        arr = as_byte_array(data)
        if mesh is None:
            mesh = data_mesh()
        K = config.K
        L = arr.shape[0]
        if L < K:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        dbg = checked_mode()
        # 'N' padding is the ambiguity class: its windows are skipped, and any
        # invalid count > 0 is a real input error
        rows, shard = _shard_with_halo(arr, mesh.size, K, pad_byte=ord("N"))
        slabs = mesh.put(rows)
        del rows
        if -(-shard // config.chunk_size) <= 1:
            cap = math.ceil(shard * config.bucket_factor / mesh.size)
            merged, (n_bad, n_valid, n_counted), overflow = sharded_count_step(
                slabs, mesh, K, cap, checked=dbg
            )
        else:
            merged, (n_bad, n_valid, n_counted), overflow = _streamed_sharded_count(
                slabs, mesh, config, checked=dbg
            )
        del slabs
        if dbg and n_valid != n_counted:
            raise RuntimeError(
                "checked mode: count conservation violated in the sharded local count — "
                f"{n_valid} valid windows but {n_counted} counted (sentinel collision or kernel bug)"
            )
        if n_bad > 0:
            raise EncodeError(ALPHABET, "<batch input>")
        if overflow > 0:
            raise RuntimeError(OVERFLOW_MESSAGE)

        rows = _gather_rows(merged, mesh)
        keys, counts = rows[:, 0], rows[:, 1]
        if mesh.size > 1:
            with annotate("kmers.rows"):
                keys, order = torch.sort(keys)
                counts = counts[order]
        kmers, counts = download_table(keys.contiguous(), counts.contiguous())
        if dbg and int(counts.sum()) != n_valid:
            # end to end: the exchange neither drops nor duplicates counts
            raise RuntimeError(
                "checked mode: count conservation violated across the exchange — "
                f"{n_valid} valid windows but {int(counts.sum())} in the merged table"
            )
        if metrics is not None:
            counted = int(counts.sum())
            metrics.end_batch(
                bases_in=L,
                windows_out=counted,
                windows_skipped=max(L - K + 1, 0) - counted,
                distinct_kmers=int(kmers.shape[0]),
            )
        return kmers, counts
