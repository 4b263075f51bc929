"""kmers_tpu_torch: the k-mer engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``kmers_tpu``, which stays the reference: module
paths mirror it, so ``kmers_tpu_torch/X.py`` is the counterpart of
``kmers_tpu/X.py``.  The port imports ``torch`` and never ``jax``; it
reuses the jax-free scalar plane of ``kmers_tpu`` (alphabets, ``Kmer``,
``io``).

- ``convert``: the register convention (one int64 per K <= 31 window,
  ``INT64_MAX`` sentinel, int64 counts) and conversion of JAX state.
- ``ops``: classification, window registers, sort-based counting, and the
  hand-written CUDA kernels in ``ops.kernels`` (sources in ``csrc/``).
- ``pipelines``: canonical k-mer counting for K <= 31.
- ``utils``: checked mode, metrics, the level stack and the drain queue.

Functions take an explicit ``device``: on ``"cuda"`` the kernels run, on
``"cpu"`` their plain torch versions.
"""

from .convert import SENTINEL
from .pipelines import (
    CountConfig,
    canonical_count,
    canonical_count_bytes,
    canonical_count_records,
    counts_lookup,
    counts_to_dict,
)

__all__ = [
    "SENTINEL",
    "CountConfig",
    "canonical_count",
    "canonical_count_bytes",
    "canonical_count_records",
    "counts_lookup",
    "counts_to_dict",
]
