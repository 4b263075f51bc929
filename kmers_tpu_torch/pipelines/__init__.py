"""End-to-end workloads of the port: canonical k-mer counting
(1 <= K <= 100), streamed counting of inputs larger than memory, the
count-table algebra and composition vectors, MinHash sketching, k-mer
extraction (every k-mer, spaced, minimizers, closed syncmers), and
six-frame amino-acid k-mer counting (1 <= K <= 32)."""

from .canonical_count import (
    CountConfig,
    canonical_count,
    canonical_count_bytes,
    canonical_count_records,
    canonical_count_words,
    composition_vector,
    counts_lookup,
    counts_to_dict,
    join_records_with_n,
)
from .extract import extract_kmers, minimizer_select, spaced_kmers, syncmer_select
from .minhash import StreamingSketcher, jaccard, minhash_sketch, sketch_fastx_stream
from .sixframe import SixFrameCountConfig, sixframe_aa_count
from .streaming import StreamingCounter, count_fastx_stream
from .tables import (
    containment,
    intersect_counts,
    jaccard_exact,
    merge_counts,
    merge_counts_device,
    multiplicity_spectrum,
    subtract_counts,
)

__all__ = [
    "CountConfig",
    "canonical_count",
    "canonical_count_bytes",
    "canonical_count_records",
    "canonical_count_words",
    "composition_vector",
    "counts_lookup",
    "counts_to_dict",
    "join_records_with_n",
    "minhash_sketch",
    "StreamingSketcher",
    "sketch_fastx_stream",
    "jaccard",
    "extract_kmers",
    "spaced_kmers",
    "minimizer_select",
    "syncmer_select",
    "SixFrameCountConfig",
    "sixframe_aa_count",
    "StreamingCounter",
    "count_fastx_stream",
    "merge_counts",
    "intersect_counts",
    "subtract_counts",
    "multiplicity_spectrum",
    "merge_counts_device",
    "jaccard_exact",
    "containment",
]
