"""Edge cases of the canonical front-ends, K1 in both modes and K3, aimed at
the boundaries of their kernels' packed tiles (``TILE`` positions a block,
32 bytes a code word), held on the CPU bit-exact against the JAX package:

- every case elementwise, in natural order, against the jnp windows
  (``canonical_windows_from_codes``, ``kmers_tpu.ops.multiword``), the jnp
  validity mask, the FxHash of ``kmers_tpu.ops.hashing`` and the byte
  counters of the jnp ``classify_2bit``;
- all of one K's cases at once as a multiset of registers (or hash keys)
  against the Pallas kernels ``canonical_windows_u32_pallas`` (both modes)
  and ``canonical_windows_mw_pallas`` in interpret mode: the cases joined
  by one 'N' each, which no window crosses, so one interpret call per K
  and mode holds every case's plain output.

The kernels themselves run these inputs on a GPU (tests/test_torch_cuda.py).
"""

import functools

import numpy as np
import pytest
import torch

from kmers_tpu.ops import multiword as jmw
from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu.ops.hashing import fx_hash_u64 as jax_fx_hash
from kmers_tpu.ops.pallas.multiword_kernel import canonical_windows_mw_pallas
from kmers_tpu.ops.pallas.window_kernel import canonical_windows_u32_pallas
from kmers_tpu.ops.windows import (
    canonical_windows_from_codes as jax_windows,
    window_valid_mask as jax_valid,
)
from kmers_tpu_torch.convert import (
    SENTINEL,
    hashes_from_jax,
    keys_from_jax,
    n_words,
    words_from_jax,
    words_to_ints,
)
from kmers_tpu_torch.ops.kernels.multiword_kernel import canonical_words_plain
from kmers_tpu_torch.ops.kernels.window_kernel import (
    TILE,
    canonical_hashes_plain,
    canonical_windows_plain,
)

K1_KS = [1, 2, 15, 16, 31]
K3_KS = [32, 33, 47, 62, 63]
CERTAIN = np.frombuffer(b"ACGTacgtu", dtype=np.uint8)
#: flagged bytes of every class: ambiguous (N, IUPAC, '-') and invalid (X)
FLAGGED = b"NXR-nkYxmN"
#: positions of the flagged bytes of the first case: both sides of code
#: words and of the first two tiles, and the last byte
EDGES = (0, 31, 32, 63, 64, TILE - 1, TILE, 2 * TILE - 1, 2 * TILE)
OFFSETS = [*range(1, 16), 17]
CASES = [
    "flags at word and tile edges",
    "N runs across code words",
    *(f"length {n}" for n in ("K-1", "K", "K+1", "31", "32", "33", "TILE-1", "TILE", "TILE+1")),
    *(f"offset {o}" for o in OFFSETS),
]


def _clean(L, rng):
    return CERTAIN[rng.integers(0, len(CERTAIN), L)]


@functools.cache
def _cases(K):
    """{case: bytes} for one K (the same names for every K)."""
    rng = np.random.default_rng(K)
    L = 2 * TILE + 100
    flags = _clean(L, rng)
    for pos, byte in zip((*EDGES, L - 1), FLAGGED):
        flags[pos] = byte
    runs = _clean(L, rng)
    runs[20:50] = ord("N")  # across the first code words' boundary
    runs[96:128] = ord("n")  # exactly one code word
    runs[TILE - 10 : TILE + 40] = ord("N")  # across the first tile's edge
    cases = {CASES[0]: flags, CASES[1]: runs}
    lengths = {"K-1": K - 1, "K": K, "K+1": K + 1, "31": 31, "32": 32, "33": 33,
               "TILE-1": TILE - 1, "TILE": TILE, "TILE+1": TILE + 1}
    for name, n in lengths.items():
        b = _clean(n, rng)
        if n > 40:
            b[n // 3] = ord("N")
        cases[f"length {name}"] = b
    # views of one buffer at small offsets, each longer than K and a code word
    buf = _clean(2 * K + 128, rng)
    buf[K + 40] = ord("R")
    for o in OFFSETS:
        cases[f"offset {o}"] = torch.from_numpy(buf)[o : o + K + 80]
    return {name: torch.as_tensor(b) for name, b in cases.items()}


def _jax_registers(b: np.ndarray, K: int):
    """The reference for one case: (registers or None, valid, n_invalid, n_ambig)."""
    if b.size == 0:
        return None, None, 0, 0
    codes, certain, ambig = jax_classify(b)
    certain, ambig = np.asarray(certain), np.asarray(ambig)
    counters = (int((~(certain | ambig)).sum()), int(ambig.sum()))
    if b.size < K:
        return None, None, *counters
    valid = torch.from_numpy(np.array(jax_valid(certain, K)))
    if K <= 31:
        regs = keys_from_jax(*jax_windows(codes, K))
    else:
        regs = words_from_jax(jmw.canonical_windows_mw(codes, K), K)
    return regs, valid, *counters


def _joined(K):
    """Every case of K joined by one 'N', padded with 'N' to the Pallas
    kernels' multiple of 4 V bytes (V = 128); the number of 'N' added."""
    V = 128
    parts = []
    for b in _cases(K).values():
        parts += [b.numpy(), np.frombuffer(b"N", np.uint8)]
    joined = np.concatenate(parts)
    pad = (-joined.size) % (4 * V)
    return np.concatenate([joined, np.full(pad, ord("N"), np.uint8)]), len(parts) // 2 + pad


def _plain_union(plain, K):
    """Every case's plain output: the keys (or word columns) of all cases
    and the summed byte counters."""
    keys, n_invalid, n_ambig = [], 0, 0
    for b in _cases(K).values():
        k, i, a = plain(b, K)
        keys.append(k)
        n_invalid += int(i)
        n_ambig += int(a)
    return torch.cat(keys, dim=-1), n_invalid, n_ambig


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", K1_KS)
def test_k1_plain_matches_jnp_elementwise(K, case):
    b = _cases(K)[case]
    regs, valid, n_invalid, n_ambig = _jax_registers(b.numpy(), K)
    L = b.shape[0]
    keys, got_invalid, got_ambig = canonical_windows_plain(b, K)
    hashes, h_invalid, h_ambig = canonical_hashes_plain(b, K)
    assert keys.shape == hashes.shape == (L,)
    n = max(L - K + 1, 0)
    want = torch.full((L,), SENTINEL)
    if regs is not None:
        want[:n] = torch.where(valid, regs, SENTINEL)
    assert torch.equal(keys, want)
    # hash mode: the JAX FxHash of each valid register, as an order key
    real = want != SENTINEL
    want_hash = torch.full((L,), SENTINEL)
    if real.any():
        u = want[real].numpy().view(np.uint64)
        hh, hl = jax_fx_hash((u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        want_hash[real] = hashes_from_jax(hh, hl)
    assert torch.equal(hashes, want_hash)
    assert (int(got_invalid), int(got_ambig)) == (int(h_invalid), int(h_ambig)) == (n_invalid, n_ambig)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", K3_KS)
def test_k3_plain_matches_jnp_elementwise(K, case):
    b = _cases(K)[case]
    regs, valid, n_invalid, n_ambig = _jax_registers(b.numpy(), K)
    L = b.shape[0]
    words, got_invalid, got_ambig = canonical_words_plain(b, K)
    assert words.shape == (n_words(K), L)
    n = max(L - K + 1, 0)
    want = torch.full((n_words(K), L), SENTINEL)
    if regs is not None:
        want[:, :n] = torch.where(valid, regs, SENTINEL)
    assert torch.equal(words, want)
    assert (int(got_invalid), int(got_ambig)) == (n_invalid, n_ambig)


@pytest.mark.parametrize("emit_hash", [False, True], ids=["register", "hash"])
@pytest.mark.parametrize("K", K1_KS)
def test_k1_plain_matches_pallas_multiset(K, emit_hash):
    joined, n_added = _joined(K)
    hi, lo, j_invalid, j_ambig = canonical_windows_u32_pallas(
        joined.view("<u4"), K, V=128, interpret=True, emit_hash=emit_hash
    )
    keys, n_invalid, n_ambig = _plain_union(
        canonical_hashes_plain if emit_hash else canonical_windows_plain, K
    )
    jkeys = (hashes_from_jax if emit_hash else keys_from_jax)(np.asarray(hi), np.asarray(lo)).numpy()
    keys = keys.numpy()
    assert (keys != SENTINEL).sum() > 1000
    assert np.array_equal(np.sort(keys[keys != SENTINEL]), np.sort(jkeys[jkeys != SENTINEL]))
    # the Pallas counters include the joining 'N's, ambiguous bytes
    assert (n_invalid, n_ambig + n_added) == (int(j_invalid), int(j_ambig))


@pytest.mark.parametrize("K", K3_KS)
def test_k3_plain_matches_pallas_multiset(K):
    joined, n_added = _joined(K)
    limbs, j_invalid, j_ambig = canonical_windows_mw_pallas(joined.view("<u4"), K, V=128, interpret=True)
    words, n_invalid, n_ambig = _plain_union(canonical_words_plain, K)
    jwords = words_from_jax(limbs, K)
    real = words[0] != SENTINEL
    assert int(real.sum()) > 1000
    assert sorted(words_to_ints(words[:, real].numpy()).tolist()) == sorted(
        words_to_ints(jwords[:, jwords[0] != SENTINEL].numpy()).tolist()
    )
    assert (n_invalid, n_ambig + n_added) == (int(j_invalid), int(j_ambig))
