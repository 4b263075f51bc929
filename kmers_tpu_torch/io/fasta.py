"""FASTA/FASTQ ingestion: the native C++ scanner, with a pure-Python fallback.

Counterpart of ``kmers_tpu/io/fasta.py``, routed as it routes: every reader
parses with the native scanner (``io/native/fastx.cpp``, the port's own
copy, built by g++ at first use) whenever it builds, and in pure Python
otherwise; ``use_native=`` picks a route.  The two scanners disagree on
malformed input (a ``>`` inside a FASTA sequence line; CRLF, blank-line
separated or multi-line FASTQ), so each route is held against the JAX
package's same route.  Records come back CSR-style: one concatenated
sequence byte buffer plus record-start offsets.
"""

from __future__ import annotations

import ctypes
import gzip

import numpy as np

from ..utils.profiling import annotate
from . import native

__all__ = [
    "read_fastx",
    "read_fastx_bytes",
    "stream_fastx",
    "native_available",
    "merge_count_tables_native",
]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_available() -> bool:
    """True when the native scanner is built and loaded."""
    return native.library() is not None


#: ``fastx_scan``'s cut rules: all of the buffer, or a streamed batch's
#: complete records (cut before its last FASTA header, or after its last
#: complete group of four FASTQ lines)
_WHOLE, _CUT_FASTA, _CUT_FASTQ = 0, 1, 2
_NO_MEMORY = -2


def _scan_native(buf: np.ndarray, cut_rule: int = _WHOLE):
    """``(seq, offsets), cut``: the records of ``buf[:cut]`` in one native
    pass; ``cut`` is ``buf.size`` under ``_WHOLE``.  ``seq`` is a view of
    a ``buf.size`` array whose pages past the records are never touched."""
    lib = native.library()
    seq = np.empty(buf.size, dtype=np.uint8)
    starts = ctypes.POINTER(ctypes.c_int64)()
    n_rec, seq_len, cut = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.fastx_scan(
        _ptr(buf, ctypes.c_uint8), buf.size, cut_rule, _ptr(seq, ctypes.c_uint8),
        ctypes.byref(starts), ctypes.byref(n_rec), ctypes.byref(seq_len), ctypes.byref(cut),
    )
    try:
        if rc == _NO_MEMORY:
            raise MemoryError("no memory for the record offsets")
        if rc != 0:
            raise ValueError("malformed FASTA/FASTQ input")
        offsets = np.ctypeslib.as_array(starts, (n_rec.value + 1,)).copy()
    finally:
        lib.fastx_free(starts)
    return (seq[: seq_len.value], offsets), cut.value


def _scan_python(buf: np.ndarray):
    data = buf.tobytes()
    if not data:
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    seqs: list[bytes] = []
    offsets = [0]
    total = 0
    if data[0:1] == b">":
        for rec in data.split(b">")[1:]:
            lines = rec.split(b"\n")
            s = b"".join(l.replace(b"\r", b"") for l in lines[1:])
            seqs.append(s)
            total += len(s)
            offsets.append(total)
    elif data[0:1] == b"@":
        lines = data.split(b"\n")
        i = 0
        while i < len(lines) and lines[i]:
            if not lines[i].startswith(b"@"):
                raise ValueError("malformed FASTQ input")
            i += 1
            seq_parts = []
            while i < len(lines) and not lines[i].startswith(b"+"):
                seq_parts.append(lines[i].replace(b"\r", b""))
                i += 1
            s = b"".join(seq_parts)
            i += 1  # '+' line
            q = 0
            while i < len(lines) and q < len(s):
                q += len(lines[i].replace(b"\r", b""))
                i += 1
            seqs.append(s)
            total += len(s)
            offsets.append(total)
            while i < len(lines) and not lines[i]:
                i += 1
    else:
        raise ValueError("malformed FASTA/FASTQ input")
    return (
        np.frombuffer(b"".join(seqs), dtype=np.uint8).copy(),
        np.asarray(offsets, dtype=np.int64),
    )


def read_fastx_bytes(data, use_native: bool | None = None):
    """Parse FASTA/FASTQ bytes -> (seq_bytes uint8, record_offsets int64).

    ``seq_bytes`` is every record's sequence concatenated (newlines and
    headers removed); ``record_offsets[i]:record_offsets[i+1]`` delimits
    record *i*.  ``use_native`` picks the scanner; by default the native one
    when it is built.
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        buf = np.asarray(data, dtype=np.uint8)
    use = native_available() if use_native is None else use_native
    if use:
        return _scan_native(np.ascontiguousarray(buf))[0]
    return _scan_python(buf)


def read_fastx(path, use_native: bool | None = None):
    """Read and parse a FASTA/FASTQ file (see :func:`read_fastx_bytes`);
    gzip-compressed files are detected by their magic bytes and inflated."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return read_fastx_bytes(data, use_native=use_native)


def merge_count_tables_native(k1, c1, k2, c2):
    """Merge two sorted ``(kmer uint64, count int64)`` tables, summing
    duplicates: the native two-pointer merge, with a numpy fallback."""
    k1 = np.ascontiguousarray(k1, dtype=np.uint64)
    c1 = np.ascontiguousarray(c1, dtype=np.int64)
    k2 = np.ascontiguousarray(k2, dtype=np.uint64)
    c2 = np.ascontiguousarray(c2, dtype=np.int64)
    lib = native.library()
    if lib is not None:
        ko = np.empty(k1.size + k2.size, dtype=np.uint64)
        co = np.empty(k1.size + k2.size, dtype=np.int64)
        n = lib.merge_count_tables(
            _ptr(k1, ctypes.c_uint64), _ptr(c1, ctypes.c_int64), k1.size,
            _ptr(k2, ctypes.c_uint64), _ptr(c2, ctypes.c_int64), k2.size,
            _ptr(ko, ctypes.c_uint64), _ptr(co, ctypes.c_int64),
        )
        return ko[:n].copy(), co[:n].copy()
    kmers = np.concatenate([k1, k2])
    counts = np.concatenate([c1, c2])
    uniq, inv = np.unique(kmers, return_inverse=True)
    summed = np.zeros(uniq.size, np.int64)
    np.add.at(summed, inv, counts)
    return uniq, summed


def join_records_native(seq: np.ndarray, offsets: np.ndarray) -> np.ndarray | None:
    """``seq``'s CSR records joined with one ``N`` between records by the
    native join (a ``memcpy`` a record); ``None`` when the library is not
    built or the offsets are not CSR (integers, non-decreasing, within
    ``seq``), which the caller's Python loop then handles."""
    lib = native.library()
    if lib is None or offsets.ndim != 1 or offsets.dtype.kind not in "iu":
        return None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_rec = offsets.size - 1
    out = np.empty(seq.size + n_rec - 1, dtype=np.uint8)
    rc = lib.fastx_join_n(
        _ptr(seq, ctypes.c_uint8), seq.size, _ptr(offsets, ctypes.c_int64), n_rec, _ptr(out, ctypes.c_uint8),
    )
    return out if rc == 0 else None


def stream_fastx(path, batch_bytes: int = 1 << 26):
    """Stream a FASTA/FASTQ file as ``(seq_bytes, record_offsets)`` batches.

    Reads ``batch_bytes``-sized blocks and parses each as a CSR record
    batch, cutting only at record boundaries: records are never split
    across batches, so a consumer of the batches sees what one parse of the
    whole file gives.  Host memory stays O(batch + largest record).  Gzip
    input streams through zlib's inflate.  FASTQ streaming assumes the
    standard 4-line record form; multi-line FASTQ takes :func:`read_fastx`.
    """
    with open(path, "rb") as raw:
        head = raw.read(2)
        raw.seek(0)
        if head == b"\x1f\x8b":
            with gzip.open(raw) as f:
                yield from _stream_fastx_file(f, batch_bytes)
        else:
            yield from _stream_fastx_file(raw, batch_bytes)


def _fastx_cut(buf: bytes, is_fastq: bool) -> int:
    """Byte index where the trailing (possibly partial) record starts;
    everything before it is complete records (the Python route's cut; the
    native scanner finds the same cut in its pass)."""
    if is_fastq:
        # standard 4-line records: cut after the last full group of 4
        # lines, which is n_lines % 4 + 1 newlines back from the end (one
        # more step absorbs a trailing partial line)
        n_lines = buf.count(b"\n")
        if n_lines // 4 == 0:
            return 0
        pos = len(buf)
        for _ in range(n_lines % 4 + 1):
            pos = buf.rfind(b"\n", 0, pos)
        return pos + 1
    cut = buf.rfind(b"\n>")
    return cut + 1 if cut != -1 else 0


def _scan_batch(buf: np.ndarray, is_fastq: bool):
    """``(records or None, cut)``: the complete records of a streamed
    batch, parsed as :func:`read_fastx_bytes` parses ``buf[:cut]``."""
    if native_available():
        records, cut = _scan_native(buf, _CUT_FASTQ if is_fastq else _CUT_FASTA)
        return (records if cut else None), cut
    data = buf.tobytes()
    cut = _fastx_cut(data, is_fastq)
    return (_scan_python(buf[:cut]) if cut else None), cut


def _read_block(f, out: np.ndarray) -> int:
    """Fill ``out`` from ``f``, as ``f.read(out.size)`` would; the bytes read."""
    view = memoryview(out)
    got = 0
    while got < out.size:
        n = f.readinto(view[got:])
        if not n:
            break
        got += n
    return got


def _stream_fastx_file(f, batch_bytes: int):
    """Each batch's read and scan runs in the span ``kmers.parse``, closed
    before the batch is yielded: the file read in ``kmers.read`` and the
    scan in ``kmers.scan`` inside it.  A block is read into one reused buffer,
    behind the tail that the last batch carried (its partial record); the
    buffer grows, inside ``kmers.read``, when that tail leaves no room."""
    buf = np.empty(batch_bytes, np.uint8)
    n_carry = 0
    is_fastq = None
    while True:
        with annotate("kmers.parse"):
            with annotate("kmers.read"):
                if buf.size < n_carry + batch_bytes:
                    grown = np.empty(n_carry + batch_bytes, np.uint8)
                    grown[:n_carry] = buf[:n_carry]
                    buf = grown
                n = n_carry + _read_block(f, buf[n_carry : n_carry + batch_bytes])
            if n == n_carry:
                break
            if is_fastq is None:
                if buf[0] == ord("@"):
                    is_fastq = True
                elif buf[0] == ord(">"):
                    is_fastq = False
                else:
                    raise ValueError("malformed FASTA/FASTQ input")
            with annotate("kmers.scan"):
                records, cut = _scan_batch(buf[:n], is_fastq)
            n_carry = n - cut
            if cut:
                buf[:n_carry] = buf[cut:n]
        if records is not None:
            yield records
    if n_carry:
        with annotate("kmers.parse"), annotate("kmers.scan"):
            records = read_fastx_bytes(buf[:n_carry])
        yield records
