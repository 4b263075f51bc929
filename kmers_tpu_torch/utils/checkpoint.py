"""Count-table checkpoints: write a ``(kmers, counts)`` table to disk, load
and merge it back, and record the inputs it was counted from.

The port's own copy of ``kmers_tpu/utils/checkpoint.py``; the format is the
contract, so a table written by either package loads bit-equal in the
other.  A checkpoint is a directory of ``part-NNNNN.npz`` partitions and a
``manifest.json`` (``K``, ``n_partitions``,
``"format": "kmers_tpu.counts.v1"`` and, when given, ``inputs``: each input
file's path, size and sha256).  A partition holds ``counts`` (int64) and
either ``kmers`` (uint64, K <= 31) or ``kmers_limbs`` (``(n, ceil(2K/64))``
uint64 little-endian limbs of the K > 31 registers, an object array of
Python ints in memory).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

__all__ = [
    "save_count_table",
    "load_count_table",
    "input_manifest_entry",
]

_MANIFEST = "manifest.json"


def input_manifest_entry(path) -> dict:
    """Provenance record of one input file: path, size, sha256 (hashed in
    1 MiB blocks)."""
    p = Path(path)
    h = hashlib.sha256()
    size = 0
    with open(p, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            h.update(block)
            size += len(block)
    return {"path": str(p), "bytes": size, "sha256": h.hexdigest()}


def _pack_limbs(kmers, K: int) -> np.ndarray:
    """Object array of Python ints -> (n, M) uint64 little-endian limbs."""
    M = -(-2 * K // 64)
    out = np.zeros((len(kmers), M), np.uint64)
    mask = (1 << 64) - 1
    for i, v in enumerate(kmers):
        v = int(v)
        for m in range(M):
            out[i, m] = (v >> (64 * m)) & mask
    return out


def _unpack_limbs(limbs: np.ndarray) -> np.ndarray:
    """(n, M) uint64 limbs -> object array of Python ints."""
    n, M = limbs.shape
    out = np.empty(n, object)
    for i in range(n):
        v = 0
        for m in range(M - 1, -1, -1):
            v = (v << 64) | int(limbs[i, m])
        out[i] = v
    return out


def save_count_table(directory, kmers: np.ndarray, counts: np.ndarray, K: int,
                     partition: int = 0, n_partitions: int = 1, inputs=None):
    """Write one partition of a ``(kmers, counts)`` table and the manifest.

    ``kmers``: uint64 (K <= 31) or an object array of Python ints (K > 31,
    stored as fixed-width limbs).  ``inputs``: optional input file paths
    (or :func:`input_manifest_entry` dicts) recorded in the manifest for
    deterministic reruns.
    """
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    kmers = np.asarray(kmers)
    counts = np.asarray(counts, np.int64)
    part = d / f"part-{partition:05d}.npz"
    if kmers.dtype == object:
        np.savez_compressed(part, kmers_limbs=_pack_limbs(kmers, K), counts=counts)
    else:
        np.savez_compressed(part, kmers=kmers.astype(np.uint64), counts=counts)
    manifest = {"K": K, "n_partitions": n_partitions, "format": "kmers_tpu.counts.v1"}
    if inputs is not None:
        manifest["inputs"] = [e if isinstance(e, dict) else input_manifest_entry(e) for e in inputs]
    (d / _MANIFEST).write_text(json.dumps(manifest))


def load_count_table(directory, return_manifest: bool = False):
    """Load and merge every partition; returns ``(kmers, counts, K)``,
    sorted (plus the manifest dict with ``return_manifest``)."""
    from ..pipelines.tables import merge_counts

    d = Path(directory)
    manifest = json.loads((d / _MANIFEST).read_text())
    kmers = np.zeros(0, np.uint64)
    counts = np.zeros(0, np.int64)
    for p in sorted(d.glob("part-*.npz")):
        with np.load(p) as z:
            k = _unpack_limbs(z["kmers_limbs"]) if "kmers_limbs" in z else z["kmers"]
            c = z["counts"]
        # partitions merge pairwise (duplicate k-mers across partitions sum)
        key = [int(v) for v in k] if k.dtype == object else k
        order = np.argsort(key, kind="stable")
        kmers, counts = merge_counts(kmers, counts, k[order], c[order])
    out = (kmers, counts, manifest["K"])
    return out + (manifest,) if return_manifest else out
