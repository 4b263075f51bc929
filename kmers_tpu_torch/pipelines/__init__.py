"""End-to-end workloads of the port: canonical k-mer counting (1 <= K <= 100)."""

from .canonical_count import (
    CountConfig,
    canonical_count,
    canonical_count_bytes,
    canonical_count_records,
    counts_lookup,
    counts_to_dict,
    join_records_with_n,
)

__all__ = [
    "CountConfig",
    "canonical_count",
    "canonical_count_bytes",
    "canonical_count_records",
    "counts_lookup",
    "counts_to_dict",
    "join_records_with_n",
]
