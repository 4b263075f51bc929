"""Edge cases of the six-frame front-ends K4 and K5, aimed at the boundaries
of their kernel's frame-major tiles (``TILE`` anchors a block, 32 bytes a
code word, a halo of 3K - 1 bytes, each anchor's codons in one of three
frames), held on the CPU bit-exact against the JAX package:

- every case elementwise, in natural order, against ``_strand_windows``
  (K <= 7) and ``_strand_windows_mw`` of ``kmers_tpu.parallel.sixframe`` on
  the forward stream and on the reverse-complement stream (reverse anchor q
  is forward anchor n - 3K - q).  The reference runs on all of one K's
  cases joined by one 'N' each, which no window crosses, with each case's
  bounds moved into the joined stream: every call of one K and genetic code
  has the same shapes;
- all of one K's cases at once as a multiset of emitted windows (sorted
  register columns), with
  ``n_valid``, against ``sixframe_windows_u32_pallas`` and
  ``sixframe_windows_mw_u32_pallas`` in interpret mode on the same joined
  stream: one interpret call per K, the K alternating between the standard
  code and NCBI table 2.

The kernels themselves run these inputs on a GPU (tests/test_torch_cuda.py).
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_tpu.genetic_codes import ncbi_trans_table as jax_codes
from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu.ops.pallas.sixframe_kernel import (
    sixframe_tbl16 as jax_tbl16,
    sixframe_windows_mw_u32_pallas,
    sixframe_windows_u32_pallas,
)
from kmers_tpu.parallel.sixframe import _strand_windows, _strand_windows_mw
from kmers_tpu_torch.convert import SENTINEL, keys_from_jax, n_words, words_from_jax
from kmers_tpu_torch.genetic_codes import ncbi_trans_table
from kmers_tpu_torch.ops.kernels.sixframe_kernel import sixframe_windows_plain, sixframe_words_plain
from kmers_tpu_torch.ops.kernels.window_kernel import TILE

KS = [1, 2, 7, 8, 10, 15, 23, 31, 32]
#: lanes of a Pallas tile (4 V bytes); an interpret call's cost is mostly
#: its trace, which grows with K, not with the ~260 grid steps at this V
V = 1024
CODES = [1, 2]  # NCBI transl_table numbers: the standard code, vertebrate mitochondrial
CERTAIN = np.frombuffer(b"ACGTacgtU", dtype=np.uint8)
#: bytes that are not certain bases: N, IUPAC codes, '!', '-', an invalid letter
FLAGGED = b"NR!nYx-kmN!Rn"
CASES = [
    "flags at word and tile edges",
    "N runs across code words and tiles",
    "bounds outside the input",
    *(f"length {n}" for n in ("3K-1", "3K", "1023", "1024", "1025", "2^20-30")),
]


def _clean(L, rng):
    return CERTAIN[rng.integers(0, len(CERTAIN), L)]


@functools.cache
def _cases(K):
    """{case: (bytes, bounds)} for one K (the same names for every K); the
    strands are clipped differently where the case does not say otherwise."""
    rng = np.random.default_rng(K)
    L = 2 * TILE + 200
    clipped = (TILE - 5, L - 40, 3, 2 * TILE + 7)
    flags = _clean(L, rng)
    # code-word edges, tile edges, the last anchor's halo, three frames
    edges = (0, 31, 32, 63, 64, 97, TILE - 1, TILE, TILE + 3 * K - 2, 2 * TILE - 1, 2 * TILE,
             2 * TILE + 3 * K - 2, L - 1)
    flags[list(edges)] = np.frombuffer(FLAGGED, np.uint8)
    runs = _clean(L, rng)
    runs[20:50] = ord("N")  # across the first code words' boundary
    runs[96:128] = ord("n")  # exactly one code word
    runs[TILE - 10 : TILE + 40] = ord("N")  # across a tile's edge, in its halo
    runs[2 * TILE - 40 : 2 * TILE + 100] = ord("R")
    cases = {CASES[0]: (flags, clipped), CASES[1]: (runs, clipped)}
    wide = _clean(3000, rng)
    wide[1500] = ord("N")
    cases[CASES[2]] = (wide, (-5, 3100, -1000, 5000))
    for name, n in {"3K-1": 3 * K - 1, "3K": 3 * K, "1023": 1023, "1024": 1024, "1025": 1025,
                    "2^20-30": (1 << 20) - 30}.items():
        b = _clean(n, rng)
        if n > 100:
            b[[n // 3, n - 3 * K - 1]] = ord("N")
        cases[f"length {name}"] = (b, (0, n, 0, n))
    return cases


@functools.cache
def _joined(K):
    """The cases of K joined by one 'N' each, padded with 'N' to the Pallas
    kernels' multiple of 4 V bytes, and each case's offset."""
    parts, offsets, at = [], {}, 0
    for name, (b, _) in _cases(K).items():
        offsets[name] = at
        parts += [b, np.frombuffer(b"N", np.uint8)]
        at += b.size + 1
    joined = np.concatenate(parts)
    pad = (-joined.size) % (4 * V)
    return np.concatenate([joined, np.full(pad, ord("N"), np.uint8)]), offsets


@functools.cache
def _jax_streams(K):
    """The joined stream's codes and certainty, forward and reverse complement."""
    joined, _ = _joined(K)
    codes, certain, _ = jax_classify(joined)
    return (codes, certain), ((codes ^ 3)[::-1], certain[::-1])


@functools.cache
def _jax_reference(K, code):
    """``_strand_windows(_mw)`` of K and a genetic code, compiled once for
    the joined stream's shape, the bounds traced (as the JAX pipelines call it)."""
    tbl = np.asarray(jax_codes[code].tbl)
    fn = _strand_windows if K <= 7 else _strand_windows_mw
    return jax.jit(lambda codes, certain, lo, hi: fn(codes, certain, K, lo, hi, tbl))


def _jax_strand(K, code, strand, lo, hi, start, stop):
    """The reference's windows of one strand of the joined stream, with the
    ownership [lo, hi) in that strand's anchors, at its anchors [start,
    stop): an int64 (1, m) key row or (W, m) word rows, SENTINEL where not
    emitted."""
    codes, certain = _jax_streams(K)[strand]
    out = _jax_reference(K, code)(codes, certain, jnp.int32(lo), jnp.int32(hi))
    *regs, valid = (np.asarray(x)[start:stop] for x in jax.tree.leaves(out))
    if K <= 7:
        return torch.where(torch.from_numpy(valid.copy()), keys_from_jax(*regs), SENTINEL)[None]
    return words_from_jax(regs, K, bps=8, valid=valid)


def _plain(K, b, bounds, code):
    build = sixframe_windows_plain if K <= 7 else sixframe_words_plain
    out, n_valid = build(torch.from_numpy(b), K, bounds, ncbi_trans_table[code])
    return out.reshape(-1, 2 * b.size), n_valid


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", KS)
def test_plain_matches_strand_windows_elementwise(K, case, code):
    b, (fw_lo, fw_hi, rv_lo, rv_hi) = _cases(K)[case]
    n = b.size
    got, n_valid = _plain(K, b, (fw_lo, fw_hi, rv_lo, rv_hi), code)
    assert got.shape == (1 if K <= 7 else n_words(K, 8), 2 * n)
    want = torch.full_like(got, SENTINEL)
    m = n - 3 * K + 1  # anchors whose window ends inside the case
    if m > 0:
        joined, offsets = _joined(K)
        o, N = offsets[case], joined.size
        # forward anchor p of the case is anchor o + p of the joined stream,
        # and reverse-complement anchor N - 3K - o - p
        q = N - 3 * K - o  # the reverse-complement anchor of p = 0
        want[:, :m] = _jax_strand(K, code, 0, o + fw_lo, o + fw_hi, o, o + m)
        want[:, n : n + m] = _jax_strand(K, code, 1, q - rv_hi + 1, q - rv_lo + 1, q - m + 1, q + 1).flip(1)
    assert torch.equal(got, want)
    assert int(n_valid) == int((got[0] != SENTINEL).sum())


@pytest.mark.parametrize("K", KS)
def test_plain_matches_pallas_multiset(K):
    code = CODES[KS.index(K) % 2]
    joined, _ = _joined(K)
    got, n_valid = [], 0
    for b, _ in _cases(K).values():
        out, nv = _plain(K, b, (0, b.size, 0, b.size), code)
        got.append(out)
        n_valid += int(nv)
    got = torch.cat(got, dim=1)
    bounds = np.zeros(128, np.int32)
    bounds[:4] = (0, joined.size, 0, joined.size)
    args = (jnp.asarray(joined.view("<u4")), jnp.asarray(bounds), K)
    kw = dict(V=V, interpret=True, tbl16=jax_tbl16(np.asarray(jax_codes[code].tbl).tobytes()))
    if K <= 7:
        hi, lo, nv = sixframe_windows_u32_pallas(*args, **kw)
        want = keys_from_jax(np.asarray(hi), np.asarray(lo))[None]
    else:
        limbs, valid, nv = sixframe_windows_mw_u32_pallas(*args, **kw)
        want = words_from_jax([np.asarray(x) for x in limbs], K, bps=8, valid=np.asarray(valid))
    real, jreal = got[0] != SENTINEL, want[0] != SENTINEL
    assert int(real.sum()) > 1000
    assert np.array_equal(_sorted_columns(got[:, real]), _sorted_columns(want[:, jreal]))
    assert n_valid == int(nv) == int(real.sum())


def _sorted_columns(words):
    """The columns of (W, n) words in lexicographic order, word 0 first: two
    multisets of registers are equal where these are."""
    words = words.numpy()
    return words[:, np.lexsort(words[::-1])]
