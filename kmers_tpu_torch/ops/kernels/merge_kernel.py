"""K9, the merge of two sorted count tables (and its merge-reduce, which
sums equal keys in the same pass), and K10, the front-packing of a count
table: their wrappers and their plain versions.

Counterparts of ``kmers_tpu/ops/pallas/merge_kernel.py::bitonic_merge_tail_pallas``
and ``::compact_tail_pallas`` (the kernels are
``kmers_tpu_torch/csrc/merge_kernel.cu``).  The TPU kernels run the in-tile
steps of two networks, a bitonic merge and a log-shift compaction; the port
computes the functions of those networks:

- :func:`merge_tables`: the rows of two tables sorted ascending by key,
  merged into one sorted table, each count moving with its key; on equal
  keys A's row comes first.  Bound by device memory (each 16-byte row read
  once and written once); K9 is a partitioned merge path in two launches:
  one thread a tile of :data:`MERGE_TILE` outputs finds the tile's co-rank
  by binary search over the tables (into a scratch of
  :func:`merge_partitions` co-ranks), then each block stages its tile's A
  and B rows in shared memory with 16-byte loads, merges them into
  registers and writes them out with 16-byte stores; counter
  ``merge_rows``.
- :func:`merge_reduce_tables`: the one-word table fold in one pass.  The
  merge of :func:`merge_tables`, equal keys summed, the runs with a
  non-sentinel key and a total > 0 front-packed, sentinel/0 after them, and
  the number of runs with a non-sentinel key.  K9's partition launch and
  one merge-reduce launch (``k9_reduce_kernel``): each block merges its tile
  as K9 does, sums each run from its head (reading on in A and B for the run
  that reaches the tile's end), and finds its output offset by a decoupled
  look-back over the tiles, so each merged row is read once and each output
  position written once.  Its plain version is the composition it replaces:
  :func:`merge_tables_plain`, the weighted RLE of ``ops/count.py`` and
  :func:`compact_table_plain`.  Counters ``merge_rows`` (both routes) and
  ``merge_reduce_rows`` (the rows the kernel took).
- :func:`merge_tables_mw`: K9's word instance, the same merge path over
  tables of W int64 word planes (``(W, n)`` keys, word 0 the most
  significant) whose rows are sorted lexicographically; A's row first on
  equal rows.  Each table's planes take their own stride, so a table cut to
  its live rows (``words[:, :nu]``) merges without a copy.  It replaces the
  stable lexicographic re-sort of the concatenation (its plain version),
  which the word fold ran at every merge; counter ``mw_merge_rows``.
- :func:`compact_table`: the rows with ``counts > 0`` front-packed in
  order, :data:`~kmers_tpu_torch.convert.SENTINEL`/0 after them, the
  length unchanged.  Keys are ``(n,)`` or ``(W, n)`` word planes, which
  move together.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...convert import SENTINEL
from ...utils.profiling import count
from . import _build

__all__ = [
    "MERGE_TILE",
    "MERGE_WORDS",
    "compact_table",
    "compact_table_plain",
    "lex_order",
    "merge_partitions",
    "merge_reduce_tables",
    "merge_reduce_tables_plain",
    "merge_tables",
    "merge_tables_mw",
    "merge_tables_mw_plain",
    "merge_tables_plain",
]

#: outputs one K9 block merges (``kMergeTile`` of ``csrc/merge_path.cuh``:
#: 256 threads of 16); K11's merge rounds use the same tile
MERGE_TILE = 4096


def merge_partitions(n: int) -> int:
    """Co-ranks of K9's scratch for ``n`` output rows: one a merge tile."""
    if n < 0:
        raise ValueError(f"length {n} must not be negative")
    return -(-n // MERGE_TILE)


def merge_tables_plain(keys_a, counts_a, keys_b, counts_b):
    """Plain torch version of :func:`merge_tables`, on any device: a stable
    sort of the concatenated keys (A's rows first, so A wins ties) and a
    gather of the counts."""
    keys, order = torch.sort(torch.cat([keys_a, keys_b]), stable=True)
    return keys, torch.cat([counts_a, counts_b])[order]


def merge_reduce_tables_plain(keys_a, counts_a, keys_b, counts_b):
    """Plain torch version of :func:`merge_reduce_tables`, on any device:
    :func:`merge_tables_plain`, the weighted run-length encoding of
    ``ops/count.py`` (each run's total on its last row) and
    :func:`compact_table_plain`."""
    from ..count import _run_length_encode  # ops/count.py imports this module

    keys, counts = merge_tables_plain(keys_a, counts_a, keys_b, counts_b)
    uniq, totals, n_unique = _run_length_encode(keys, counts)
    keys, counts = compact_table_plain(uniq, totals)
    return keys, counts, n_unique


#: word widths K9's word instance is built for: 2-4 words of a nucleotide
#: register (K <= 100), up to 5 of a six-frame one (K <= 32, 8 bits a residue)
MERGE_WORDS = (2, 3, 4, 5)


def lex_order(words: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the columns of ``(W, n)`` words
    lexicographically: W stable sorts, least significant word first."""
    order = None
    for w in reversed(range(words.shape[0])):
        key = words[w] if order is None else words[w][order]
        idx = torch.sort(key, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def merge_tables_mw_plain(words_a, counts_a, words_b, counts_b):
    """Plain torch version of :func:`merge_tables_mw`, on any device: a
    stable lexicographic sort of the concatenated columns (A's first, so A
    wins ties) and a gather of the counts."""
    words = torch.cat([words_a, words_b], 1)
    order = lex_order(words)
    return words[:, order], torch.cat([counts_a, counts_b])[order]


def compact_table_plain(keys, counts):
    """Plain torch version of :func:`compact_table`, on any device: every
    real row is scattered to its rank, every hole to a spare slot that is
    dropped."""
    n = counts.shape[0]
    real = counts > 0
    dest = torch.where(real, torch.cumsum(real, 0) - 1, n)
    out_k = torch.full((*keys.shape[:-1], n + 1), SENTINEL, dtype=torch.int64, device=keys.device)
    out_c = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    out_k.scatter_(-1, dest.expand_as(keys), keys)
    out_c.scatter_(0, dest, torch.where(real, counts, 0))
    return out_k[..., :n], out_c[:n]


@functools.cache
def _merge_kernel():
    v = ctypes.c_void_p
    ll = ctypes.c_longlong
    return _build.kernel("k9_merge_tables", (v, v, ll, v, v, ll, v, ll, v, v, v))


@functools.cache
def _merge_reduce_kernel():
    v = ctypes.c_void_p
    ll = ctypes.c_longlong
    return _build.kernel("k9_merge_reduce_tables", (v, v, ll, v, v, ll, v, ll, v, v, v))


@functools.cache
def _reduce_tile() -> int:
    """Rows a block of K9's merge-reduce owns, from the kernel source that
    owns the tile size."""
    fn = _build.library().k9_reduce_tile
    fn.restype = ctypes.c_int
    return fn()


@functools.cache
def _word_merge_kernel():
    v = ctypes.c_void_p
    ll = ctypes.c_longlong
    return _build.kernel(
        "k9w_merge_tables", (ctypes.c_int, v, ll, v, ll, v, ll, v, ll, v, ll, v, v, v)
    )


@functools.cache
def _word_merge_tile(words: int) -> int:
    """Outputs a K9 word block owns at ``words`` words, from the kernel
    source that owns the tile size."""
    fn = _build.library().k9w_merge_tile
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(words)


@functools.cache
def _compact_kernel():
    v = ctypes.c_void_p
    return _build.kernel(
        "k10_compact_table", (v, v, ctypes.c_longlong, ctypes.c_int, v, v, v, v)
    )


@functools.cache
def _compact_scratch_elems():
    """K10's scratch size for n rows, from the kernel source that owns the
    tile size."""
    fn = _build.library().k10_scratch_elems
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn


def _route(name: str, tensors, dense=torch.Tensor.is_contiguous) -> bool:
    """Check the wrapper's tensors; True when they lie on a CUDA device
    (launch the kernel), False on the CPU (take the plain version).  A CUDA
    tensor must be ``dense`` (by default contiguous)."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"{name} takes int64 tensors")
        if t.device != dev:
            raise ValueError(f"{name} takes tensors on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(dense(t) for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


def _rows_dense(t: torch.Tensor) -> bool:
    """Every plane's rows lie side by side (the plane stride is free)."""
    return t.shape[-1] <= 1 or t.stride(-1) == 1


def _check_tables(name: str, tensors) -> None:
    keys_a, counts_a, keys_b, counts_b = tensors
    if any(t.dim() != 1 for t in tensors) or keys_a.shape != counts_a.shape \
            or keys_b.shape != counts_b.shape:
        raise ValueError(f"{name} takes two tables of 1-D keys and counts of one length")


def merge_tables(keys_a, counts_a, keys_b, counts_b):
    """Merge two count tables whose 1-D int64 ``keys`` are sorted
    ascending (padding rows, if any, only at the tail).

    Returns ``(keys, counts)`` of length ``len(keys_a) + len(keys_b)``,
    sorted by key, A's row first on equal keys.  Nothing is summed
    (:func:`merge_reduce_tables` sums).  A CUDA tensor launches K9 (a
    partition and a merge launch, counted once); a CPU tensor takes
    :func:`merge_tables_plain`.  Counter ``merge_rows``: the rows merged,
    on either route.
    """
    tensors = (keys_a, counts_a, keys_b, counts_b)
    _check_tables("merge_tables", tensors)
    na, nb = keys_a.shape[0], keys_b.shape[0]
    count("merge_rows", na + nb)
    if not _route("merge_tables", tensors):
        return merge_tables_plain(*tensors)
    keys = torch.empty(na + nb, dtype=torch.int64, device=keys_a.device)
    counts = torch.empty_like(keys)
    if na + nb:
        tiles = merge_partitions(na + nb)
        scratch = torch.empty(tiles, dtype=torch.int64, device=keys.device)
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _merge_kernel()(
                keys_a.data_ptr(), counts_a.data_ptr(), na, keys_b.data_ptr(),
                counts_b.data_ptr(), nb, scratch.data_ptr(), tiles, keys.data_ptr(),
                counts.data_ptr(), stream,
            )
        _build.check(code, "k9_merge_tables")
        merge_tables.launches += 1
    return keys, counts


def merge_reduce_tables(keys_a, counts_a, keys_b, counts_b):
    """Merge two count tables whose 1-D int64 ``keys`` are sorted
    ascending (padding rows, if any, only at the tail) and sum equal keys.

    Returns ``(keys, counts, n_unique)``: ``keys`` and ``counts`` of length
    ``len(keys_a) + len(keys_b)``, the runs of equal keys whose key is not
    :data:`~kmers_tpu_torch.convert.SENTINEL` and whose total is > 0 first,
    in key order (each total summed mod 2^64, as int64), then sentinel/0;
    ``n_unique`` a 0-d int64 tensor on the tables' device, the number of
    runs whose key is not the sentinel.  A CUDA tensor launches K9's
    partition and its merge-reduce (counted once); a CPU tensor takes
    :func:`merge_reduce_tables_plain`.  Counters: ``merge_rows``, the rows
    merged, on either route; ``merge_reduce_rows``, the rows the kernel
    took (none on the plain route).
    """
    tensors = (keys_a, counts_a, keys_b, counts_b)
    _check_tables("merge_reduce_tables", tensors)
    na, nb = keys_a.shape[0], keys_b.shape[0]
    count("merge_rows", na + nb)
    if not _route("merge_reduce_tables", tensors):
        return merge_reduce_tables_plain(*tensors)
    count("merge_reduce_rows", na + nb)
    keys = torch.empty(na + nb, dtype=torch.int64, device=keys_a.device)
    counts = torch.empty_like(keys)
    if not na + nb:
        return keys, counts, torch.zeros((), dtype=torch.int64, device=keys.device)
    tiles = -(-(na + nb) // _reduce_tile())
    # the co-ranks, the tiles' status words, the ticket and the distinct count
    scratch = torch.empty(2 * tiles + 2, dtype=torch.int64, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _merge_reduce_kernel()(
            keys_a.data_ptr(), counts_a.data_ptr(), na, keys_b.data_ptr(),
            counts_b.data_ptr(), nb, scratch.data_ptr(), tiles, keys.data_ptr(),
            counts.data_ptr(), stream,
        )
    _build.check(code, "k9_merge_reduce_tables")
    merge_reduce_tables.launches += 1
    return keys, counts, scratch[-1]


def merge_tables_mw(words_a, counts_a, words_b, counts_b):
    """Merge two word count tables whose ``(W, n)`` int64 word planes are
    sorted lexicographically by column, word 0 first (padding columns, if
    any, only at the tail), for W in :data:`MERGE_WORDS`.

    Returns ``(words, counts)``: ``(W, na + nb)`` contiguous words and
    their counts, sorted, A's column first on equal columns.  Nothing is
    summed.  Each plane's rows must be dense; the plane stride is free, so
    views cut to their live rows need no copy.  A CUDA tensor launches K9's
    word instance (a partition and a merge launch, counted once); a CPU
    tensor takes :func:`merge_tables_mw_plain`.  Counter ``mw_merge_rows``:
    the columns merged, on either route.
    """
    tensors = (words_a, counts_a, words_b, counts_b)
    if words_a.dim() != 2 or words_b.dim() != 2 or counts_a.dim() != 1 or counts_b.dim() != 1 \
            or words_a.shape[0] != words_b.shape[0] or words_a.shape[1] != counts_a.shape[0] \
            or words_b.shape[1] != counts_b.shape[0]:
        raise ValueError(
            "merge_tables_mw takes two tables of (W, n) words and (n,) counts of one width W"
        )
    W = words_a.shape[0]
    if W not in MERGE_WORDS:
        raise ValueError(f"merge_tables_mw is built for W in {MERGE_WORDS} words (got {W})")
    na, nb = counts_a.shape[0], counts_b.shape[0]
    count("mw_merge_rows", na + nb)
    if not _route("merge_tables_mw", tensors, _rows_dense):
        return merge_tables_mw_plain(*tensors)
    words = torch.empty((W, na + nb), dtype=torch.int64, device=words_a.device)
    counts = torch.empty(na + nb, dtype=torch.int64, device=words_a.device)
    if na + nb:
        tile = _word_merge_tile(W)
        tiles = -(-(na + nb) // tile)
        scratch = torch.empty(tiles, dtype=torch.int64, device=words.device)
        with torch.cuda.device(words.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _word_merge_kernel()(
                W, words_a.data_ptr(), words_a.stride(0), counts_a.data_ptr(), na,
                words_b.data_ptr(), words_b.stride(0), counts_b.data_ptr(), nb,
                scratch.data_ptr(), tiles, words.data_ptr(), counts.data_ptr(), stream,
            )
        _build.check(code, "k9w_merge_tables")
        merge_tables_mw.launches += 1
    return words, counts


def compact_table(keys, counts):
    """Front-pack the real rows (``counts > 0``) of a count table.

    ``keys`` is int64 ``(n,)`` or ``(W, n)``, ``counts`` int64 ``(n,)``.
    Returns ``(keys, counts)`` of the input's shapes: the real rows in
    order, then :data:`~kmers_tpu_torch.convert.SENTINEL` in every word and
    count 0.  A CUDA tensor launches K10 (three launches under one entry
    point, counted once); a CPU tensor takes :func:`compact_table_plain`.
    """
    if counts.dim() != 1 or keys.dim() not in (1, 2) or keys.shape[-1] != counts.shape[0]:
        raise ValueError("compact_table takes keys (n,) or (W, n) and counts (n,)")
    if not _route("compact_table", (keys, counts)):
        return compact_table_plain(keys, counts)
    n = counts.shape[0]
    out_k = torch.empty_like(keys)
    out_c = torch.empty_like(counts)
    if n:
        words = 1 if keys.dim() == 1 else keys.shape[0]
        scratch = torch.empty(
            _compact_scratch_elems()(n), dtype=torch.int64, device=counts.device
        )
        with torch.cuda.device(counts.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = _compact_kernel()(
                keys.data_ptr(), counts.data_ptr(), n, words, scratch.data_ptr(),
                out_k.data_ptr(), out_c.data_ptr(), stream,
            )
        _build.check(code, "k10_compact_table")
        compact_table.launches += 1
    return out_k, out_c


#: wrapper calls in this process that launched their kernel (K9's two, its
#: merge-reduce's two and K10's three launches count once)
merge_tables.launches = 0
merge_reduce_tables.launches = 0
merge_tables_mw.launches = 0
compact_table.launches = 0
