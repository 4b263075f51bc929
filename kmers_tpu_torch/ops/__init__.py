"""The port's compute plane: classification, window registers, counting of
one- and multi-word registers, and the CUDA kernels (``ops.kernels``)."""

from .count import (
    SENTINEL,
    compact_counts,
    merge_compact_tables,
    merge_sorted_counts,
    sort_count,
)
from .encode import classify_2bit
from .multiword import (
    canonical_windows_mw,
    canonical_windows_mw_bytes,
    merge_compact_tables_mw,
    sort_count_mw,
)
from .windows import canonical_windows_from_codes, window_valid_mask

__all__ = [
    "SENTINEL",
    "classify_2bit",
    "canonical_windows_from_codes",
    "window_valid_mask",
    "sort_count",
    "compact_counts",
    "merge_sorted_counts",
    "merge_compact_tables",
    "canonical_windows_mw",
    "canonical_windows_mw_bytes",
    "sort_count_mw",
    "merge_compact_tables_mw",
]
