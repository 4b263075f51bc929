"""Hand-written CUDA kernels of the port, each beside its plain torch version.

========  ====================================  ==================================================
kernel    wrapper (module)                      TPU kernel it replaces
========  ====================================  ==================================================
K1        ``window_kernel.canonical_windows``   ``window_kernel.canonical_windows_u32_pallas``
K1 hash   ``window_kernel.canonical_hashes``    the same, with ``emit_hash=True``
K2        ``rle_kernel.rle_unit``               ``rle_kernel.rle_unit_pallas``
K3        ``multiword_kernel.canonical_words``  ``multiword_kernel.canonical_windows_mw_pallas``
K4        ``sixframe_kernel.sixframe_windows``  ``sixframe_kernel.sixframe_windows_u32_pallas``
K5        ``sixframe_kernel.sixframe_words``    ``sixframe_kernel.sixframe_windows_mw_u32_pallas``
K6        ``general_kernel.windows_general``    ``general_kernel.windows_pallas_general``
========  ====================================  ==================================================

A wrapper given a CUDA tensor launches its kernel (built on first use by
:mod:`._build`) or raises; given a CPU tensor it runs the plain version.
The package imports none of its modules: the plain versions build on
``ops``, whose counting imports K2, so callers import the module they use.
"""
