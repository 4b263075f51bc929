"""Port parity for kernel K2's plain version, ``rle_unit_plain``, slot by
slot against the JAX package's Pallas ``rle_unit_pallas`` (interpret mode)
and its jnp ``_run_length_encode``, on the cases of the JAX package's own
RLE kernel tests.  The kernel itself runs only on a GPU
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kmers_tpu.ops.count import _run_length_encode as jax_rle
from kmers_tpu.ops.pallas.rle_kernel import rle_unit_pallas
from kmers_tpu_torch.convert import keys_from_jax
from kmers_tpu_torch.ops.kernels.rle_kernel import rle_unit, rle_unit_plain

SENT32 = np.uint32(0xFFFFFFFF)


def _case(name, rng):
    """(hi, lo, W) of one case, as uint32 limbs."""
    if name == "random_duplicates":
        n = 5000
        return rng.integers(0, 50, n), rng.integers(0, 4, n), 256
    if name == "sentinel_tail":
        n = 3000
        hi, lo = rng.integers(0, 20, n), rng.integers(0, 3, n)
        hi[-100:] = SENT32
        lo[-100:] = SENT32
        return hi, lo, 256
    if name == "all_unique":
        return np.arange(1000), np.arange(1000), 256
    if name == "run_spanning_blocks":
        return np.zeros(2000), np.zeros(2000), 256
    if name == "boundary_at_block_edge":
        return np.repeat(np.arange(8), 256), np.zeros(8 * 256), 256
    if name == "row_boundary_runs":
        return np.repeat(np.arange(16), 128), np.zeros(16 * 128), 128
    if name == "tile_aligned":
        n = 3 * 8 * 128
        return np.sort(rng.integers(0, 40, n)), np.zeros(n), 128
    if name == "length_not_multiple_of_w":
        n = 777
        return rng.integers(0, 9, n), rng.integers(0, 2, n), 256
    raise ValueError(name)


CASES = [
    "random_duplicates",
    "sentinel_tail",
    "all_unique",
    "run_spanning_blocks",
    "boundary_at_block_edge",
    "row_boundary_runs",
    "tile_aligned",
    "length_not_multiple_of_w",
]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_slot_by_slot(name, rng):
    hi, lo, W = _case(name, rng)
    hi, lo = np.asarray(hi, np.uint32), np.asarray(lo, np.uint32)
    shi, slo = lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2, is_stable=False)
    skeys = keys_from_jax(np.asarray(shi), np.asarray(slo))
    # the port's own sort of the same keys gives the same order
    assert torch.equal(torch.sort(keys_from_jax(hi, lo)).values, skeys)
    uniq, counts, n_unique = rle_unit_plain(skeys)
    for want in (jax_rle(shi, slo), rle_unit_pallas(shi, slo, W=W, interpret=True)):
        wh, wl, wc, wn = (np.asarray(x) for x in want)
        assert torch.equal(uniq, keys_from_jax(wh, wl))
        assert np.array_equal(counts.numpy(), wc.astype(np.int64))
        assert int(n_unique) == int(wn)


def test_empty():
    uniq, counts, n_unique = rle_unit_plain(torch.zeros(0, dtype=torch.int64))
    wh, wl, wc, wn = rle_unit_pallas(
        np.zeros(0, np.uint32), np.zeros(0, np.uint32), interpret=True
    )
    assert uniq.numel() == counts.numel() == np.asarray(wh).size == 0
    assert int(n_unique) == int(wn) == 0


def test_wrapper_takes_plain_version_on_cpu(rng):
    keys = torch.sort(torch.from_numpy(rng.integers(0, 30, 999))).values
    before = rle_unit.launches
    got = rle_unit(keys)
    assert rle_unit.launches == before
    for g, w in zip(got, rle_unit_plain(keys)):
        assert torch.equal(g, w)


def test_wrapper_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        rle_unit(torch.zeros(4, dtype=torch.int32))
