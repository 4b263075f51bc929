"""kmers_tpu_torch: the k-mer engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``kmers_tpu``, which stays the reference: module
paths mirror it, so ``kmers_tpu_torch/X.py`` is the counterpart of
``kmers_tpu/X.py``, and the top level exports every name the reference's
does.  The port imports ``torch`` and never ``jax``, and nothing of the
``kmers_tpu`` package either, not even its jax-free modules: it keeps its
own copies of what it needs (the scalar plane, ``io``).

- top level: the scalar API plane, host-side Python and numpy copied whole
  from the reference — symbols, alphabets, the :class:`Kmer` value type of
  every alphabet (``Mer``, ``KmerType``, ``DNAKmer`` and the other
  factories, ``fx_hash``, ``derive_type``, ``derive_words``, ``n_words``,
  ``mer``), ``Seq``, construction (``recoding_scheme``, ``unsafe_extract``,
  ``unsafe_shift_from``), the iterators (``FwKmers``, ``CanonicalKmers``,
  ``UnambiguousKmers``, ``SpacedKmers`` and their shorthands,
  ``each_codon``), the function API (``translate`` to ``from_integer``),
  the NCBI genetic codes, reverse translation and random k-mers.  Bit-exact
  with the reference; the oracle of the device plane (``chip_smoke.py``
  holds the kernels' paths against it on the card).
- ``convert``: the register convention (``ceil(K / 31)`` int64 words of 62
  bits per register, ``INT64_MAX`` sentinel, int64 counts), the hash-key
  convention (FxHash with the sign bit flipped, so signed order is unsigned
  hash order) and conversion of JAX state.
- ``ops``: classification, window registers (2, 4 and 8 bits a symbol),
  FxHash, minimizers and syncmers, translation and reverse translation,
  six-frame amino-acid windows, sort-based counting of one- and
  multi-word registers, the device table fold (merge and compaction),
  the bitonic sort (on no default path), and the hand-written CUDA kernels
  in ``ops.kernels`` (sources in ``csrc/``).
- ``parallel``: the sharded pipelines over a mesh of ranks (one process
  or a ``torch.distributed`` group): canonical counting, minimizers and
  six-frame counting.
- ``pipelines``: canonical k-mer counting for 1 <= K <= 100 and
  composition vectors; streamed counting (``StreamingCounter``,
  ``count_fastx_stream``) and the count-table algebra (``merge_counts``,
  ``merge_counts_device`` and the rest of ``pipelines.tables``); MinHash
  sketching (``minhash_sketch``, ``StreamingSketcher``,
  ``sketch_fastx_stream``, ``jaccard``); k-mer
  extraction (``extract_kmers``, ``spaced_kmers``, ``minimizer_select``,
  ``syncmer_select``); six-frame amino-acid k-mer counting
  (``sixframe_aa_count``, ``SixFrameCountConfig``).
- ``genetic_codes``, ``revtrans``: besides the scalar API, the tables the
  device ops read: ``sixframe_tbl16`` for translation
  (``ops.translate_ops``, the six-frame kernels) and ``codon_set_masks``
  for reverse translation (``ops.revtrans_ops``).
- ``random``: besides the host functions, random K-mer registers made on
  the device (``rand_kmers_device``).
- ``io``: a FASTA/FASTQ reader and batch streamer (a native C++ scanner
  built by g++ at first use, pure Python where it cannot be built).
- ``utils``: checked mode, metrics, the level stack, the drain queue,
  count-table checkpoints and profiling hooks.

The device plane's functions take an explicit ``device``: on ``"cuda"``
the kernels run, on ``"cpu"`` their plain torch versions.
"""

from .alphabets import (
    ASCII_SKIPPING_LUT,
    Alphabet,
    AminoAcidAlphabet,
    CharAlphabet,
    DNAAlphabet,
    DNAAlphabet2,
    DNAAlphabet4,
    NucleicAcidAlphabet,
    RNAAlphabet,
    RNAAlphabet2,
    RNAAlphabet4,
)
from .construction import (
    AsciiEncode,
    Copyable,
    FourToTwo,
    GenericRecoding,
    RecodingScheme,
    TwoToFour,
    recoding_scheme,
    shift_encoding,
    unsafe_extract,
    unsafe_shift_from,
)
from .convert import SENTINEL
from .functions import (
    as_integer,
    canonical,
    complement,
    delete,
    from_integer,
    iscanonical,
    pop,
    pop_first,
    push,
    push_first,
    reverse,
    reverse_complement,
    shift,
    shift_first,
    translate,
)
from .genetic_codes import GeneticCode, TranslationError, ncbi_trans_table, standard_genetic_code
from .iterators import (
    CanonicalDNAMers,
    CanonicalKmers,
    CanonicalRNAMers,
    FwAAMers,
    FwDNAMers,
    FwKmers,
    FwRNAMers,
    FwRvIterator,
    SpacedAAMers,
    SpacedDNAMers,
    SpacedKmers,
    SpacedRNAMers,
    UnambiguousDNAMers,
    UnambiguousKmers,
    UnambiguousRNAMers,
    each_codon,
)
from .kmer import (
    AAKmer,
    DNACodon,
    DNAKmer,
    Kmer,
    KmerType,
    Mer,
    RNACodon,
    RNAKmer,
    derive_type,
    derive_words,
    fx_hash,
    mer,
    n_words,
)
from .pipelines import (
    CountConfig,
    StreamingCounter,
    StreamingSketcher,
    canonical_count,
    canonical_count_bytes,
    canonical_count_records,
    canonical_count_words,
    composition_vector,
    containment,
    count_fastx_stream,
    counts_lookup,
    counts_to_dict,
    extract_kmers,
    intersect_counts,
    jaccard,
    jaccard_exact,
    merge_counts,
    merge_counts_device,
    minhash_sketch,
    minimizer_select,
    multiplicity_spectrum,
    SixFrameCountConfig,
    sixframe_aa_count,
    sketch_fastx_stream,
    spaced_kmers,
    subtract_counts,
    syncmer_select,
)
from .random import rand_from_kmer, rand_kmer, rand_kmers, rand_kmers_device, rand_kmers_mw, rand_symbol
from .revtrans import (
    CodonSet,
    ReverseGeneticCode,
    rev_standard_genetic_code,
    reverse_translate,
    reverse_translate_into,
)
from .seq import BioSequence, Seq
from .symbols import DNA, RNA, AminoAcid, EncodeError, NucleicAcid

__version__ = "0.1.0"

__all__ = [
    "DNA",
    "RNA",
    "AminoAcid",
    "NucleicAcid",
    "EncodeError",
    "Alphabet",
    "NucleicAcidAlphabet",
    "DNAAlphabet",
    "DNAAlphabet2",
    "DNAAlphabet4",
    "RNAAlphabet",
    "RNAAlphabet2",
    "RNAAlphabet4",
    "AminoAcidAlphabet",
    "CharAlphabet",
    "ASCII_SKIPPING_LUT",
    "Seq",
    "BioSequence",
    "Kmer",
    "Mer",
    "KmerType",
    "DNAKmer",
    "RNAKmer",
    "AAKmer",
    "DNACodon",
    "RNACodon",
    "mer",
    "fx_hash",
    "derive_type",
    "derive_words",
    "n_words",
    "RecodingScheme",
    "Copyable",
    "TwoToFour",
    "FourToTwo",
    "AsciiEncode",
    "GenericRecoding",
    "recoding_scheme",
    "unsafe_extract",
    "unsafe_shift_from",
    "shift_encoding",
    "CodonSet",
    "ReverseGeneticCode",
    "rev_standard_genetic_code",
    "reverse_translate",
    "reverse_translate_into",
    "translate",
    "complement",
    "reverse",
    "reverse_complement",
    "canonical",
    "iscanonical",
    "push",
    "push_first",
    "shift",
    "shift_first",
    "pop",
    "pop_first",
    "delete",
    "as_integer",
    "from_integer",
    "FwKmers",
    "FwDNAMers",
    "FwRNAMers",
    "FwAAMers",
    "FwRvIterator",
    "CanonicalKmers",
    "CanonicalDNAMers",
    "CanonicalRNAMers",
    "UnambiguousKmers",
    "UnambiguousDNAMers",
    "UnambiguousRNAMers",
    "SpacedKmers",
    "SpacedDNAMers",
    "SpacedRNAMers",
    "SpacedAAMers",
    "each_codon",
    "rand_symbol",
    "rand_from_kmer",
    "rand_kmer",
    "rand_kmers",
    "rand_kmers_mw",
    "rand_kmers_device",
    "SENTINEL",
    "CountConfig",
    "canonical_count",
    "canonical_count_bytes",
    "canonical_count_records",
    "canonical_count_words",
    "composition_vector",
    "counts_lookup",
    "counts_to_dict",
    "StreamingCounter",
    "count_fastx_stream",
    "merge_counts",
    "intersect_counts",
    "subtract_counts",
    "multiplicity_spectrum",
    "merge_counts_device",
    "jaccard_exact",
    "containment",
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
    "GeneticCode",
    "standard_genetic_code",
    "ncbi_trans_table",
    "TranslationError",
]
