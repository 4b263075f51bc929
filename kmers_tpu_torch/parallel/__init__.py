"""The parallel plane: sharded pipelines over a mesh of ranks.

Counterpart of ``kmers_tpu/parallel/``: halo slabs, per-rank counting on
the single-device kernels (canonical k-mers, minimizers, six-frame amino
acids), and one hash-prefix exchange of the local count tables.  A :class:`Mesh` holds its ranks in
one process (any world size, devices may repeat) or one rank a process of
a ``torch.distributed`` group (NCCL on GPUs, gloo on CPUs); see
:func:`data_mesh`.  Every function equals its single-device counterpart at
any world size.
"""

from .mesh import Mesh, data_mesh
from .minimizers import sharded_minimizer_select
from .multiword import exchange_and_merge_mw, sharded_canonical_count_mw
from .pipeline import (
    ShardedCountConfig,
    exchange_and_merge,
    sharded_canonical_count,
    sharded_count_step,
)
from .sixframe import SixFrameCountConfig, sharded_sixframe_aa_count

__all__ = [
    "Mesh",
    "data_mesh",
    "ShardedCountConfig",
    "sharded_canonical_count",
    "sharded_count_step",
    "exchange_and_merge",
    "exchange_and_merge_mw",
    "sharded_canonical_count_mw",
    "sharded_minimizer_select",
    "SixFrameCountConfig",
    "sharded_sixframe_aa_count",
]
