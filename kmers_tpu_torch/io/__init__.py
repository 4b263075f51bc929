"""Host-side ingestion: FASTA/FASTQ parsing (native scanner, Python fallback)."""

from .fasta import (
    merge_count_tables_native,
    native_available,
    read_fastx,
    read_fastx_bytes,
    stream_fastx,
)

__all__ = [
    "read_fastx",
    "read_fastx_bytes",
    "stream_fastx",
    "native_available",
    "merge_count_tables_native",
]
