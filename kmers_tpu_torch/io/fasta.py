"""FASTA/FASTQ ingestion, in pure Python.

Counterpart of the pure-Python scanner of ``kmers_tpu/io/fasta.py``
(``_scan_python``, ``read_fastx_bytes``, ``read_fastx``, and the batched
``stream_fastx``); the port keeps its own copy and imports nothing of the
JAX package.  The JAX package's native C++ scanner is not carried over.
Records come back CSR-style: one concatenated sequence byte buffer plus
record-start offsets.
"""

from __future__ import annotations

import gzip

import numpy as np

__all__ = ["read_fastx", "read_fastx_bytes", "stream_fastx"]


def _scan(data: bytes):
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


def read_fastx_bytes(data):
    """Parse FASTA/FASTQ bytes -> (seq_bytes uint8, record_offsets int64).

    ``seq_bytes`` is every record's sequence concatenated (newlines and
    headers removed); ``record_offsets[i]:record_offsets[i+1]`` delimits
    record *i*.
    """
    if not isinstance(data, (bytes, bytearray, memoryview)):
        data = np.asarray(data, dtype=np.uint8).tobytes()
    return _scan(bytes(data))


def read_fastx(path):
    """Read and parse a FASTA/FASTQ file (see :func:`read_fastx_bytes`);
    gzip-compressed files are detected by their magic bytes and inflated."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return read_fastx_bytes(data)


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
    everything before it is complete records."""
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


def _stream_fastx_file(f, batch_bytes: int):
    carry = b""
    is_fastq = None
    while True:
        block = f.read(batch_bytes)
        if not block:
            break
        buf = carry + block
        if is_fastq is None:
            if buf[:1] == b"@":
                is_fastq = True
            elif buf[:1] == b">":
                is_fastq = False
            else:
                raise ValueError("malformed FASTA/FASTQ input")
        cut = _fastx_cut(buf, is_fastq)
        emit, carry = buf[:cut], buf[cut:]
        if emit:
            yield read_fastx_bytes(emit)
    if carry:
        yield read_fastx_bytes(carry)
