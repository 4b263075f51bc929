"""The port's register convention, and conversion of state to and from
the JAX package.

- A K <= 31 window register is one ``int64``.  Real registers hold at
  most 62 bits, so they are never negative and signed order equals the
  JAX package's unsigned ``(hi, lo)`` order.  torch has no ``>>`` or
  ``<`` for ``uint32`` on the CPU, so the JAX package's pair of ``uint32``
  limbs (``kmers_tpu/ops/u64.py``) is not carried over.
- Invalid windows hold :data:`SENTINEL` (``INT64_MAX``), which sorts after
  every real register.  The JAX sentinel, all-ones in both limbs, would
  be ``-1`` as an ``int64`` and sort first.
- Counts are ``int64`` (the JAX package counts in ``int32``).
- A count table is a pair ``(keys, counts)`` of ``int64`` tensors with
  ascending keys; rows with a zero count are padding.

Public outputs are exactly the JAX package's: sorted ``np.uint64`` k-mers
and ``np.int64`` counts.  The functions below convert internal state at
the boundary, so that tests can hand both packages the same state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SENTINEL",
    "KEY_BITS_MAX",
    "keys_from_jax",
    "keys_to_jax",
    "table_from_jax",
]

#: register of an invalid window (sorts after every real register)
SENTINEL = (1 << 63) - 1
#: widest register the int64 convention holds below the sentinel
KEY_BITS_MAX = 62

_JAX_LIMB_SENT = 0xFFFFFFFF


def keys_from_jax(hi, lo, device=None) -> torch.Tensor:
    """JAX ``(hi, lo)`` uint32 register pairs -> the port's int64 keys.

    The JAX all-ones sentinel becomes :data:`SENTINEL`; any other pair
    wider than 62 bits raises ``ValueError``.
    """
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    sent = (hi == _JAX_LIMB_SENT) & (lo == _JAX_LIMB_SENT)
    full = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    if (full[~sent] >> np.uint64(KEY_BITS_MAX)).any():
        raise ValueError("register wider than 62 bits")
    keys = np.where(sent, np.int64(SENTINEL), full.astype(np.int64))
    return torch.from_numpy(keys).to(device)


def keys_to_jax(keys: torch.Tensor):
    """The port's int64 keys -> JAX ``(hi, lo)`` uint32 numpy arrays,
    :data:`SENTINEL` back to all-ones."""
    k = keys.detach().cpu().numpy().astype(np.int64)
    full = k.astype(np.uint64)
    full[k == SENTINEL] = np.uint64(0xFFFFFFFFFFFFFFFF)
    hi = (full >> np.uint64(32)).astype(np.uint32)
    lo = (full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def table_from_jax(uh, ul, cnt, device=None):
    """A JAX sentinel-interspersed count table (numpy ``uh, ul, cnt``) ->
    the port's front-packed table ``(keys, counts)``: its real rows
    (count > 0), in order, as int64 tensors."""
    cnt = np.asarray(cnt)
    real = cnt > 0
    keys = keys_from_jax(np.asarray(uh)[real], np.asarray(ul)[real], device)
    counts = torch.from_numpy(cnt[real].astype(np.int64)).to(device)
    return keys, counts
