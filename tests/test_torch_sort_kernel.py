"""Port parity for kernel K11, the bitonic sort: the plain versions
``bitonic_sort_plain`` and ``bitonic_local_sort_plain`` against the Pallas
kernels ``bitonic_sort_pallas`` and ``bitonic_local_sort_pallas`` in
interpret mode, bit for bit, on the cases of
``tests/test_pallas.py::TestBitonicSortKernel`` and on arbitrary u32 pairs;
the error contracts; the wrappers on the CPU.  JAX ``(hi, lo)`` pairs map to
the port's int64 keys by ``convert.hashes_from_jax``, which keeps their
unsigned order (all-ones becomes ``SENTINEL``).  The kernels themselves run
only on a GPU (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_tpu.ops.pallas.sort_kernel import bitonic_local_sort_pallas, bitonic_sort_pallas
from kmers_tpu_torch.convert import SENTINEL, hashes_from_jax
from kmers_tpu_torch.ops import bitonic_local_sort, bitonic_sort
from kmers_tpu_torch.ops.kernels.merge_kernel import MERGE_TILE
from kmers_tpu_torch.ops.kernels.sort_kernel import (
    DEFAULT_TILE,
    MAX_TILE,
    bitonic_local_sort_plain,
    bitonic_sort_plain,
    sort_plan,
)

W = 128
TILE = 8 * W  # the JAX kernel's tile at W = 128


def _pairs(n, seed, hi_max=1 << 32, lo_max=1 << 32):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, hi_max, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, lo_max, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def _jax(fn, hi, lo):
    sh, sl = fn(jnp.asarray(hi), jnp.asarray(lo), W=W, interpret=True)
    return hashes_from_jax(np.asarray(sh), np.asarray(sl))


@pytest.mark.parametrize("tiles", [1, 2, 8])
def test_plain_sort_matches_pallas(tiles):
    hi, lo = _pairs(tiles * TILE, tiles, hi_max=50, lo_max=1 << 16)
    got = bitonic_sort_plain(hashes_from_jax(hi, lo), TILE)
    assert torch.equal(got, _jax(bitonic_sort_pallas, hi, lo))


def test_plain_sort_matches_pallas_with_sentinels():
    hi, lo = _pairs(2 * TILE, 30, hi_max=10, lo_max=4)
    mask = np.random.default_rng(31).random(hi.size) < 0.3
    hi[mask] = 0xFFFFFFFF
    lo[mask] = 0xFFFFFFFF
    keys = hashes_from_jax(hi, lo)
    assert int((keys == SENTINEL).sum()) == int(mask.sum())
    got = bitonic_sort_plain(keys, TILE)
    assert torch.equal(got, _jax(bitonic_sort_pallas, hi, lo))
    assert (got[-int(mask.sum()) :] == SENTINEL).all()


def test_plain_sort_matches_pallas_on_full_range_pairs():
    # hi >= 2^31 on about half the pairs: negative keys, sorted first
    hi, lo = _pairs(4 * TILE, 4)
    keys = hashes_from_jax(hi, lo)
    assert (keys < 0).any() and (keys >= 0).any()
    got = bitonic_sort_plain(keys, TILE)
    assert torch.equal(got, _jax(bitonic_sort_pallas, hi, lo))
    assert torch.equal(got, torch.sort(keys).values)


def test_plain_local_sort_matches_pallas():
    # four tiles, alternately ascending and descending
    hi, lo = _pairs(4 * TILE, 5)
    keys = hashes_from_jax(hi, lo)
    got = bitonic_local_sort_plain(keys, TILE)
    assert torch.equal(got, _jax(bitonic_local_sort_pallas, hi, lo))
    for t in range(4):
        tile = keys[t * TILE : (t + 1) * TILE]
        want = torch.sort(tile, descending=bool(t % 2)).values
        assert torch.equal(got[t * TILE : (t + 1) * TILE], want)


def test_plain_local_sort_matches_pallas_on_three_tiles():
    # the local pass takes any multiple of the tile, not only powers of two
    hi, lo = _pairs(3 * TILE, 6, hi_max=1 << 31)
    got = bitonic_local_sort_plain(hashes_from_jax(hi, lo), TILE)
    assert torch.equal(got, _jax(bitonic_local_sort_pallas, hi, lo))


@pytest.mark.parametrize("n", [TILE + 8, 3 * TILE, TILE // 2])
def test_value_errors_match_jax(n):
    hi, lo = _pairs(n, 7)
    keys = hashes_from_jax(hi, lo)
    for port, jax_fn in [(bitonic_sort_plain, bitonic_sort_pallas), (bitonic_sort, bitonic_sort_pallas),
                         (bitonic_local_sort_plain, bitonic_local_sort_pallas),
                         (bitonic_local_sort, bitonic_local_sort_pallas)]:
        try:
            jax_fn(jnp.asarray(hi), jnp.asarray(lo), W=W, interpret=True)
        except ValueError:
            with pytest.raises(ValueError, match=f"length {n}"):
                port(keys, TILE)
        else:
            assert torch.equal(port(keys, TILE), _jax(jax_fn, hi, lo))


@pytest.mark.parametrize("tile", [0, 3, 1000, 2 * MAX_TILE, -4])
def test_tiles_that_are_no_power_of_two_or_too_large_raise(tile):
    keys = torch.zeros(4 * MAX_TILE, dtype=torch.int64)
    for fn in (bitonic_sort, bitonic_sort_plain, bitonic_local_sort, bitonic_local_sort_plain):
        with pytest.raises(ValueError, match="tile"):
            fn(keys, tile)


def test_wrong_dtype_or_rank_raises():
    with pytest.raises(TypeError):
        bitonic_sort(torch.zeros(1024, dtype=torch.int32))
    with pytest.raises(TypeError):
        bitonic_local_sort(torch.zeros(2, 1024, dtype=torch.int64), 1024)


def _edge_cases():
    rng = np.random.default_rng(8)
    n = 4096
    rand = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64))
    extremes = rand.clone()
    extremes[::97] = torch.iinfo(torch.int64).min
    extremes[5::89] = torch.iinfo(torch.int64).max
    sentinels = rand.clone()
    sentinels[torch.from_numpy(rng.random(n) < 0.3)] = SENTINEL
    return {
        "all equal": torch.full((n,), 12345, dtype=torch.int64),
        "all sentinel": torch.full((n,), SENTINEL, dtype=torch.int64),
        "sorted": torch.sort(rand).values,
        "reverse sorted": torch.sort(rand, descending=True).values,
        "int64 extremes": extremes,
        "30 % sentinels": sentinels,
        "one key": torch.tensor([7], dtype=torch.int64),
    }


@pytest.mark.parametrize("name", list(_edge_cases()))
@pytest.mark.parametrize("tile", [1, 2, 1024])
def test_wrapper_on_cpu_sorts_edge_cases(name, tile):
    keys = _edge_cases()[name]
    tile = min(tile, keys.shape[0])
    copy = keys.clone()
    before = bitonic_sort.launches, bitonic_local_sort.launches
    got = bitonic_sort(keys, tile)
    assert (bitonic_sort.launches, bitonic_local_sort.launches) == before
    assert torch.equal(got, torch.sort(keys).values)
    # the full sort does not depend on the tile; its input is left as it was
    assert torch.equal(bitonic_sort(keys), got)
    assert torch.equal(keys, copy)


def test_default_tile_and_empty_input():
    assert DEFAULT_TILE <= MAX_TILE and DEFAULT_TILE & (DEFAULT_TILE - 1) == 0
    keys = torch.from_numpy(np.random.default_rng(9).integers(0, 1 << 40, 2 * DEFAULT_TILE))
    assert torch.equal(bitonic_sort(keys), torch.sort(keys).values)
    local = bitonic_local_sort(keys)
    assert torch.equal(local[:DEFAULT_TILE], torch.sort(keys[:DEFAULT_TILE]).values)
    assert torch.equal(local[DEFAULT_TILE:], torch.sort(keys[DEFAULT_TILE:], descending=True).values)
    empty = torch.zeros(0, dtype=torch.int64)
    assert bitonic_sort(empty).shape == (0,) and bitonic_local_sort(empty, 1024).shape == (0,)


@pytest.mark.parametrize(
    "n,plan",
    [(0, (1, 0, 0)), (1, (1, 0, 0)), (2, (2, 0, 0)), (DEFAULT_TILE, (DEFAULT_TILE, 0, 0)),
     (2 * DEFAULT_TILE, (DEFAULT_TILE, 1, 2 * DEFAULT_TILE // MERGE_TILE)),
     (1 << 20, (DEFAULT_TILE, 7, 256)), (1 << 24, (DEFAULT_TILE, 11, 4096)),
     (1 << 26, (DEFAULT_TILE, 13, 16384))],
)
def test_sort_plan_rounds_and_scratch(n, plan):
    tile, rounds, partitions = sort_plan(n)
    assert (tile, rounds, partitions) == plan
    # the tile kernel's runs, doubled once a round, end as one run of n keys
    assert tile << rounds == max(n, 1)
    if rounds:
        # a round's pairs of runs are whole merge tiles, one co-rank each
        assert (2 * tile) % MERGE_TILE == 0 and partitions * MERGE_TILE == n


@pytest.mark.parametrize("n", [-1, 3, 12, 3 * DEFAULT_TILE])
def test_sort_plan_rejects_lengths_that_are_no_power_of_two(n):
    with pytest.raises(ValueError, match=f"length {n}"):
        sort_plan(n)


def test_full_sort_tile_argument_only_validates():
    # the full sort's result does not depend on the tile it is given: every
    # valid tile gives torch.sort's order, and an invalid one raises first
    keys = torch.from_numpy(np.random.default_rng(10).integers(-(1 << 62), 1 << 62, 1 << 12))
    want = torch.sort(keys).values
    for tile in (1, 16, 1024, 1 << 12):
        assert torch.equal(bitonic_sort(keys, tile), want)
    with pytest.raises(ValueError, match="length"):
        bitonic_sort(keys, 1 << 13)
