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
K8b       ``general_kernel.windows_k32``        ``window_kernel.canonical_windows_pallas`` at K = 32
K9        ``merge_kernel.merge_tables``         ``merge_kernel.bitonic_merge_tail_pallas``
K9        ``merge_kernel.merge_reduce_tables``  the same merge, with the weighted RLE and K10
K10       ``merge_kernel.compact_table``        ``merge_kernel.compact_tail_pallas``
K11       ``sort_kernel.bitonic_local_sort``    ``sort_kernel.bitonic_local_sort_pallas``
K11       ``sort_kernel.bitonic_sort``          ``sort_kernel.bitonic_sort_pallas``
K12       ``minimizer_kernel.ChunkMinimizers``  none: the JAX package selects minimizers in ``jnp``
========  ====================================  ==================================================

K7 (``window_kernel.canonical_windows_bytes_flat_pallas``, the byte form
of K1 with flat outputs) is K1's function up to a bijective output order,
so the port calls K1 for it (``pipelines/canonical_count.py::_count_chunk``).

A wrapper given a CUDA tensor launches its kernel (built on first use by
:mod:`._build`) or raises; given a CPU tensor it runs the plain version.
The package imports none of its modules: the plain versions build on
``ops``, whose counting imports K2, so callers import the module they use
(``ops`` itself re-exports K11's two functions, which need nothing of it).
"""
