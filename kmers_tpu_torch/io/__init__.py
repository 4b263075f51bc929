"""Host-side ingestion: FASTA/FASTQ parsing."""

from .fasta import read_fastx, read_fastx_bytes, stream_fastx

__all__ = ["read_fastx", "read_fastx_bytes", "stream_fastx"]
