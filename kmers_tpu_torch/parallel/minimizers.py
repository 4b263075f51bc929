"""Sharded (W, K)-minimizer selection over a :class:`~.mesh.Mesh`.

Counterpart of ``kmers_tpu/parallel/minimizers.py``.  Minimizer window
``j`` covers k-mers ``[j, j + W)``, so bases ``[j, j + W + K - 1)``: each
rank owns ``shard`` consecutive windows and holds their bases plus a right
halo of ``W + K - 2``.  A rank runs the single-device window path of
``pipelines/extract.py`` (kernel K6, ``windows_general``, on its slab) and
the sliding minimum of ``ops/minimizer.py``, keeps the windows inside the
input, and shifts their positions by its first window.  Neighbouring
windows that share a minimizer may sit on two ranks; the dedup by position
of the gathered selections removes such repeats as it removes them within
a rank, so the result equals single-device ``minimizer_select`` at any
world size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.minimizer import minimizers, minimizers_masked
from ..pipelines._input import ALPHABET, as_byte_array
from ..pipelines.extract import _extract
from ..symbols import EncodeError
from .mesh import Mesh, data_mesh
from .pipeline import _slabs

__all__ = ["sharded_minimizer_select"]


def sharded_minimizer_select(data, K: int = 15, W: int = 10, mesh: Mesh | None = None,
                             skip_ambiguous: bool = False):
    """Canonical (W, K)-minimizers across the ranks of ``mesh``, as
    ``(values np.uint64, positions np.int64)`` without repeats, equal to
    ``minimizer_select(data, K, W, skip_ambiguous=...)`` on one device.

    With ``skip_ambiguous=False`` the input must hold certain bases only;
    with ``skip_ambiguous=True`` k-mers with an ambiguous base are no
    candidates (invalid bytes still raise ``EncodeError``).
    """
    arr = as_byte_array(data)
    if mesh is None:
        mesh = data_mesh()
    L = arr.shape[0]
    span = W + K - 1
    n_global = L - span + 1
    if n_global < 1:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    shard = -(-n_global // mesh.size)
    # pad with 'N' under skipping (never a candidate), 'A' otherwise (the
    # padding's windows lie past n_global and are dropped)
    pad_byte = ord("N") if skip_ambiguous else ord("A")
    slabs = mesh.put(_slabs(arr, mesh.size, shard, span - 1, pad_byte))
    parts, bad = [], []
    for rank, slab in zip(mesh.ranks, slabs):
        win, valid, (n_invalid, n_ambig) = _extract(slab, K, canonical=True)
        # the whole slab, halo included: a bad halo byte is also in the
        # next rank's body, and only > 0 is tested
        bad.append(n_invalid + (0 if skip_ambiguous else n_ambig))
        kmer, pos = minimizers_masked(win, valid, W) if skip_ambiguous else minimizers(win, W)
        first = rank * shard
        j = torch.arange(shard, device=slab.device) + first
        keep = (pos >= 0) & (j < n_global)
        parts.append(torch.stack([kmer[keep], pos[keep] + first], 1))
    (n_bad,) = mesh.sum(bad)
    if n_bad > 0:
        msg = "<invalid base>" if skip_ambiguous else "<ambiguous or invalid base>"
        raise EncodeError(ALPHABET, msg)
    rows = torch.cat(mesh.gather(parts))
    pos, order = torch.sort(rows[:, 1], stable=True)
    # equal positions hold the same k-mer: keep the first of each
    first = torch.ones_like(pos, dtype=torch.bool)
    first[1:] = pos[1:] != pos[:-1]
    kmers = rows[:, 0][order][first]
    return kmers.cpu().numpy().view(np.uint64), pos[first].cpu().numpy()
