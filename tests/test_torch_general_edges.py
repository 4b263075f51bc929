"""Edge cases of the code-stream front-ends K6 (``windows_general``) and K8b
(``windows_k32``), aimed at the boundaries of their kernel's packed code
tiles (``TILE`` positions a block, 32 symbols a group, one 32-symbol halo
group), held on the CPU bit-exact against the JAX package:

- K6's plain version, every case elementwise, in natural order, against
  ``windows_pallas_general`` in interpret mode in ten configurations of
  width, K and mode;
- K8b's plain version at K = 32, canonical, against
  ``canonical_windows_pallas`` in interpret mode; forward, against the same
  kernel through the reverse complement (the canonical register of a window
  is the unsigned minimum of its forward register and that of the reverse
  complement stream's mirrored window) and against the jnp forward windows;
  the validity plane against the jnp validity mask.

The Pallas kernels run once per configuration on all of its cases joined by
one bad symbol each, which no window crosses. The kernels themselves run
these inputs on a GPU (tests/test_torch_cuda.py).
"""

import functools

import numpy as np
import pytest
import torch

from kmers_tpu.ops import u64 as jax_u64
from kmers_tpu.ops import windows as jax_windows
from kmers_tpu.ops.encode import pack_words
from kmers_tpu.ops.pallas.general_kernel import windows_pallas_general
from kmers_tpu.ops.pallas.window_kernel import canonical_windows_pallas, linearize_offset_major
from kmers_tpu_torch.convert import SENTINEL, keys_from_jax
from kmers_tpu_torch.ops.kernels.general_kernel import windows_general_plain, windows_k32_plain
from kmers_tpu_torch.ops.kernels.window_kernel import TILE

#: (bps, K, canonical) of K6
CONFIGS = [(2, 1, True), (2, 16, False), (2, 31, True), (2, 31, False), (4, 1, True),
           (4, 8, False), (4, 15, True), (8, 1, False), (8, 4, False), (8, 7, False)]
W = 128  # lanes of a Pallas tile
LENGTHS = {"K-1": -1, "K": 0, "K+1": 1, "31": 31, "32": 32, "33": 33, "1023": 1023, "1024": 1024,
           "1025": 1025, "1056": 1056, "2^20-1": (1 << 20) - 1, "2^20+1": (1 << 20) + 1}
CASES = ["bad at group, tile and halo edges", "bad runs across groups and tiles",
         "codes at the top of their range", *(f"length {n}" for n in LENGTHS)]


def _length(name, K):
    n = LENGTHS[name]
    return K + n if n < 31 else n


@functools.cache
def _cases(bps, K):
    """{case: (codes uint8, good bool)} for one width and K (the same names
    for every configuration)."""
    rng = np.random.default_rng(100 * bps + K)
    top = (1 << bps) - 1

    def stream(L):
        return rng.integers(0, top + 1, L).astype(np.uint8), rng.random(L) > 0.002

    L = 3 * TILE + 5
    codes, good = stream(L)
    # both sides of groups and tiles; the last symbol a tile's last window
    # reads (TILE + K - 2) and the halo group's last (TILE + 31)
    good[[0, 31, 32, 63, 64, TILE - 1, TILE, TILE + 1, TILE + K - 2, TILE + 31, 2 * TILE - 1,
          2 * TILE, 2 * TILE + K - 2, L - 1]] = False
    cases = {CASES[0]: (codes, good)}
    codes, good = stream(L)
    good[20:50] = False  # across the first groups' boundary
    good[96:128] = False  # exactly one group
    good[TILE - 10 : TILE + 40] = False  # across a tile's edge, in its halo
    good[2 * TILE - 40 : 2 * TILE + 100] = False
    cases[CASES[1]] = (codes, good)
    codes = np.full(2 * TILE + 77, top, np.uint8)
    good = np.ones(codes.size, bool)
    good[[TILE // 2, TILE + 3]] = False
    cases[CASES[2]] = (codes, good)
    for name in LENGTHS:
        codes, good = stream(_length(name, K))
        if codes.size > 40:
            good[codes.size // 3] = False
        cases[f"length {name}"] = (codes, good)
    return cases


@functools.cache
def _joined(bps, K):
    """The cases of one width and K joined by one bad symbol each (code 0),
    and each case's offset."""
    codes, good, offsets, at = [], [], {}, 0
    for name, (c, g) in _cases(bps, K).items():
        offsets[name] = at
        codes += [c, np.zeros(1, np.uint8)]
        good += [g, np.zeros(1, bool)]
        at += c.size + 1
    return np.concatenate(codes), np.concatenate(good), offsets


@functools.cache
def _pallas_general(bps, K, canonical):
    """``windows_pallas_general`` of the joined stream in natural order."""
    codes, good, _ = _joined(bps, K)
    hi, lo = windows_pallas_general(codes, good, K, bps=bps, canonical=canonical, W=W, interpret=True)
    n = codes.size
    return keys_from_jax(linearize_offset_major(hi, n), linearize_offset_major(lo, n))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bps,K,canonical", CONFIGS)
def test_plain_matches_pallas_general(bps, K, canonical, case):
    codes, good = _cases(bps, K)[case]
    got = windows_general_plain(torch.from_numpy(codes), torch.from_numpy(good), K, bps, canonical)
    assert got.shape == codes.shape
    o = _joined(bps, K)[2][case]
    # the joined stream's windows at the case's last K - 1 positions cross
    # its separator: the sentinel, as the plain version's past the end
    assert torch.equal(got, _pallas_general(bps, K, canonical)[o : o + codes.size])
    n = codes.size - K + 1
    if case.startswith("codes"):
        assert (got[:n] != SENTINEL).sum() > n // 2
    assert (got[max(n, 0) :] == SENTINEL).all()


def _unsigned(x):
    return x.numpy().view(np.uint64)


@functools.cache
def _pallas_k32():
    """``canonical_windows_pallas`` at K = 32 of the joined stream, the
    64-bit registers in natural order (unmasked; valid where the windows lie
    inside the stream)."""
    codes, _, _ = _joined(2, 32)
    words = pack_words(codes.astype(np.uint32), bps=2, pad_words=2)
    hi, lo = canonical_windows_pallas(np.asarray(words), 32, W=W, interpret=True)
    n = codes.size - 31
    hi, lo = (np.asarray(linearize_offset_major(x, n)).astype(np.uint64) for x in (hi, lo))
    return (hi << np.uint64(32)) | lo


def _rc(codes):
    return np.ascontiguousarray((codes ^ 3)[::-1])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("canonical", [False, True])
def test_k32_plain_matches_canonical_windows_pallas(canonical, case):
    codes, good = _cases(2, 32)[case]
    L = codes.size
    regs, valid = windows_k32_plain(torch.from_numpy(codes), torch.from_numpy(good), canonical)
    assert regs.shape == valid.shape == (L,)
    n = max(L - 31, 0)
    o = _joined(2, 32)[2][case]
    want = _pallas_k32()[o : o + n]
    if canonical:
        assert np.array_equal(_unsigned(regs[:n]), want)
    else:
        # forward registers, and through the reverse complement's forward
        # registers (its window n - 1 - i mirrors window i) the canonical ones
        rc, _ = windows_k32_plain(torch.from_numpy(_rc(codes)), torch.from_numpy(good[::-1].copy()))
        fw, rv = _unsigned(regs[:n]), _unsigned(rc[:n])[::-1]
        assert np.array_equal(np.minimum(fw, rv), want)
        if n:
            jnp_fw = jax_windows.windows_from_codes(codes.astype(np.uint32), 32, 2)
            assert np.array_equal(fw, jax_u64.to_numpy(tuple(np.asarray(x) for x in jnp_fw)))
    assert np.array_equal(valid[:n].numpy(), np.asarray(jax_windows.window_valid_mask(good, 32))[:n])
    assert not regs[n:].any() and not valid[n:].any()
    if case.startswith("codes"):
        # all 3s: T^32, its reverse complement A^32 = 0
        assert int(valid.sum()) > n // 2 and (regs[:n] == (0 if canonical else -1)).all()
