"""Hand-written CUDA kernels of the port, each beside its plain torch version.

========  ===========================  =========================================
kernel    wrapper                      TPU kernel it replaces
========  ===========================  =========================================
K1        ``canonical_windows``        ``window_kernel.canonical_windows_u32_pallas``
K2        ``rle_unit``                 ``rle_kernel.rle_unit_pallas``
========  ===========================  =========================================

A wrapper given a CUDA tensor launches its kernel (built on first use by
:mod:`._build`) or raises; given a CPU tensor it runs the plain version.
"""

from .rle_kernel import rle_unit, rle_unit_plain
from .window_kernel import canonical_windows, canonical_windows_plain

__all__ = [
    "canonical_windows",
    "canonical_windows_plain",
    "rle_unit",
    "rle_unit_plain",
]
