"""The port's compute plane: classification and encoding, window
registers, hashing, register statistics, minimizers, translation and
reverse translation, six-frame amino-acid windows, counting of one- and
multi-word registers, the device table fold (merge and compaction), the
bitonic sort (kernel K11, on no default path), and the CUDA kernels
(``ops.kernels``)."""

from .count import (
    SENTINEL,
    compact_counts,
    merge_compact_tables,
    merge_sorted_counts,
    sort_count,
)
from .encode import classify_2bit, encode_table
from .hashing import fx_hash_u64, fx_hash_words
from .kernels.sort_kernel import bitonic_local_sort, bitonic_sort
from .minimizer import closed_syncmer_mask, minimizers, minimizers_masked, sliding_min_u64
from .multiword import (
    windows_mw,
    rc_windows_mw,
    canonical_windows_mw,
    fx_hash_mw,
    n_limbs,
    canonical_windows_mw_bytes,
    merge_compact_tables_mw,
    sort_count_mw,
)
from .revtrans_ops import codon_set_table, reverse_translate_codes
from .sixframe import sixframe_windows_from_bytes, sixframe_words_from_bytes
from .stats import gc_count_u64, popcount32
from .translate_ops import aa_kmer_windows, six_frame_aa_kmers, six_frame_codes, translate_codes
from .windows import (
    canonical_windows_4bit_from_codes,
    canonical_windows_from_codes,
    rc_windows_4bit_from_codes,
    rc_windows_from_codes,
    window_valid_mask,
    windows_from_codes,
)

__all__ = [
    "SENTINEL",
    "classify_2bit",
    "encode_table",
    "windows_from_codes",
    "rc_windows_from_codes",
    "canonical_windows_from_codes",
    "rc_windows_4bit_from_codes",
    "canonical_windows_4bit_from_codes",
    "window_valid_mask",
    "fx_hash_u64",
    "fx_hash_words",
    "popcount32",
    "gc_count_u64",
    "sliding_min_u64",
    "minimizers",
    "minimizers_masked",
    "closed_syncmer_mask",
    "sort_count",
    "compact_counts",
    "merge_sorted_counts",
    "merge_compact_tables",
    "bitonic_local_sort",
    "bitonic_sort",
    "windows_mw",
    "rc_windows_mw",
    "canonical_windows_mw",
    "canonical_windows_mw_bytes",
    "n_limbs",
    "fx_hash_mw",
    "sort_count_mw",
    "merge_compact_tables_mw",
    "translate_codes",
    "six_frame_codes",
    "aa_kmer_windows",
    "six_frame_aa_kmers",
    "codon_set_table",
    "reverse_translate_codes",
    "sixframe_windows_from_bytes",
    "sixframe_words_from_bytes",
]
