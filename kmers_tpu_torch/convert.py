"""The port's register convention, and conversion of state to and from
the JAX package.

- A register of K symbols of ``bps`` bits is a ``bps * K``-bit string
  cut big-endian into ``W = n_words(K, bps) = ceil(bps * K / 62)``
  ``int64`` words of 62 bits; word 0, the most significant, keeps what is
  left over (fewer bits).  Real words are never negative, so signed
  lexicographic order over the words equals the order of the registers
  (and the JAX package's unsigned limb order).  A register of at most 62
  bits is the ``W = 1`` case: one ``int64`` per window, kept as a 1-D
  tensor.  torch has no ``>>`` or ``<`` for ``uint32`` on the CPU, so the
  JAX package's ``uint32`` limbs (``kmers_tpu/ops/u64.py``,
  ``ops/multiword.py``) are not carried over.
- Nucleotide k-mers have ``bps = 2``: a word holds 31 bases, word 0 the
  first ``K - 31 (W - 1)``.  Amino-acid k-mers (six-frame counting,
  K <= 32) have ``bps = 8``: K <= 7 is one int64 key of at most 56 bits,
  8 <= K <= 32 takes W = 2..5 words.  62 is not a multiple of 8, so at
  every K >= 8 some amino-acid byte straddles two words.
- An invalid window holds :data:`SENTINEL` (``INT64_MAX``) in every word.
  No real word reaches it, so it sorts after every real register and
  collides with none at any K.  The JAX package's registers fill their
  32-bit limbs exactly where ``bps * K`` is a multiple of 32 (K = 32, 48,
  64, 80, 96 nucleotides; K = 4m amino acids), where its all-ones sentinel
  equals a real register; there it carries an explicit validity operand
  (the six-frame kernel K5 emits a validity stream for this alone).  The
  port's 62-bit words leave the sentinel free at every width, so it needs
  no such stream.  The JAX sentinel, all-ones limbs, would be ``-1`` as an
  ``int64`` and sort first.
- Counts are ``int64`` (the JAX package counts in ``int32``).
- A count table is a pair ``(keys, counts)``: ``keys`` of shape ``(n,)``
  for K <= 31 or ``(W, n)``, ``counts`` ``int64`` of shape ``(n,)``, rows
  in ascending order; rows with a zero count are padding.

Hashes (minhash, minimizers, syncmers) follow a second convention:

- The seed-0 FxHash of a single-word register is ``reg * FX mod 2^64``
  (``ops/hashing.py``), and minhash and minimizers order hashes as
  **unsigned** 64-bit integers.
- A hash is kept as an int64 **order key**, ``key = hash ^ (1 << 63)``
  (the sign bit flipped), so signed order of the keys is unsigned order of
  the hashes, and ``torch.sort`` / ``torch.topk`` on int64 keys give the
  JAX package's order.
- The JAX package's "invalid window" hash is all-ones; its key is
  ``0x7FFF...FF``, exactly :data:`SENTINEL`.
- Public outputs stay ``np.uint64`` hashes: :func:`hashes_to_uint64`.
  :func:`hashes_from_jax` takes the JAX package's ``(hh, hl)`` uint32 pair
  to keys.
- A 64-bit register (K = 32 at 2 bits) is a raw bit pattern in int64: it
  is compared as unsigned (the sign bit flipped) and its public output is
  its ``np.uint64`` view.

Public outputs are exactly the JAX package's: sorted ``np.uint64`` k-mers
(K <= 31) or a sorted object array of Python ints (K > 31), and ``np.int64``
counts.  The functions below convert internal state at the boundary, so
that tests can hand both packages the same state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SENTINEL",
    "KEY_BITS_MAX",
    "WORD_BASES",
    "n_words",
    "SIGN_BIT",
    "keys_from_jax",
    "keys_to_jax",
    "hashes_from_jax",
    "hashes_to_uint64",
    "table_from_jax",
    "words_from_jax",
    "words_to_jax",
    "words_to_ints",
]

#: register word of an invalid window (sorts after every real word)
SENTINEL = (1 << 63) - 1
#: widest register word the int64 convention holds below the sentinel
KEY_BITS_MAX = 62
#: bases in a full register word
WORD_BASES = KEY_BITS_MAX // 2
#: ``1 << 63`` as an int64 (``INT64_MIN``): XOR turns a hash into its
#: order key and back
SIGN_BIT = -(1 << 63)

_JAX_LIMB_SENT = 0xFFFFFFFF
_WORD_MASK = np.uint64((1 << KEY_BITS_MAX) - 1)


def n_words(K: int, bps: int = 2) -> int:
    """Register words of a K-mer of ``bps``-bit symbols: ``ceil(bps K / 62)``."""
    return -(-bps * K // KEY_BITS_MAX)


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


def hashes_from_jax(hh, hl, device=None) -> torch.Tensor:
    """JAX ``(hh, hl)`` uint32 hash pairs -> the port's int64 order keys
    (all-ones, the JAX invalid hash, becomes :data:`SENTINEL`)."""
    full = (np.asarray(hh, np.uint32).astype(np.uint64) << np.uint64(32)) | np.asarray(
        hl, np.uint32
    ).astype(np.uint64)
    return torch.from_numpy(full.view(np.int64) ^ np.int64(SIGN_BIT)).to(device)


def hashes_to_uint64(keys: torch.Tensor) -> np.ndarray:
    """The port's int64 order keys -> the public ``np.uint64`` hashes."""
    return (keys.detach() ^ SIGN_BIT).cpu().numpy().view(np.uint64)


def _per_rank(arrays, n_ranks: int) -> list:
    """Cut each array (the per-device blocks of a JAX sharded output, laid
    end to end) into ``n_ranks`` equal blocks: one tuple a rank."""
    return list(zip(*(np.split(np.asarray(x), n_ranks) for x in arrays)))


def table_from_jax(uh, ul, cnt, device=None, n_ranks=None):
    """A JAX sentinel-interspersed count table (numpy ``uh, ul, cnt``) ->
    the port's front-packed table ``(keys, counts)``: its real rows
    (count > 0), in order, as int64 tensors.  With ``n_ranks`` the arrays
    hold one equal block a device (a sharded output) and the result is a
    list of each rank's table."""
    if n_ranks is not None:
        return [table_from_jax(*block, device) for block in _per_rank((uh, ul, cnt), n_ranks)]
    cnt = np.asarray(cnt)
    real = cnt > 0
    keys = keys_from_jax(np.asarray(uh)[real], np.asarray(ul)[real], device)
    counts = torch.from_numpy(cnt[real].astype(np.int64)).to(device)
    return keys, counts


def _regroup(parts, part_bits: int, out_bits: int, n_out: int) -> list:
    """Cut the bit string held big-endian in ``parts`` (uint64 arrays of
    ``part_bits`` bits each) into ``n_out`` big-endian pieces of
    ``out_bits`` bits, as uint64 arrays (the top piece keeps what is left)."""
    n_in = len(parts)
    out = []
    for o in range(n_out):
        lo = out_bits * (n_out - 1 - o)
        acc = np.zeros(parts[0].shape, np.uint64)
        for p, x in enumerate(parts):
            base = part_bits * (n_in - 1 - p)
            if base + part_bits <= lo or base >= lo + out_bits:
                continue  # no bit of this part falls in this piece
            if base >= lo:
                acc |= x << np.uint64(base - lo)
            else:
                acc |= x >> np.uint64(lo - base)
        out.append(acc & np.uint64((1 << out_bits) - 1))
    return out


def words_from_jax(limbs, K: int, device=None, bps: int = 2, valid=None, n_ranks=None):
    """JAX ``M = ceil(bps K / 32)`` uint32 limbs (limb 0 most significant)
    -> the port's ``(W, n)`` int64 words.  With ``n_ranks`` the limbs (and
    ``valid``) hold one equal block a device (a sharded output) and the
    result is a list of each rank's words.

    Invalid windows become :data:`SENTINEL` in every word: those where
    ``valid`` (the JAX validity stream, nonzero = real) is zero, or, with
    no ``valid``, those whose limbs are all ones, the JAX sentinel (for
    nucleotides at ``2K = 32 M`` all-ones is also the forward register of
    K ``T``'s, which is never canonical).  Any other register wider than
    ``bps K`` bits raises ``ValueError``.
    """
    if n_ranks is not None:
        blocks = _per_rank(limbs, n_ranks)
        valids = [None] * n_ranks if valid is None else np.split(np.asarray(valid), n_ranks)
        return [words_from_jax(b, K, device, bps, v) for b, v in zip(blocks, valids)]
    limbs = [np.asarray(x, np.uint32) for x in limbs]
    M = -(-bps * K // 32)
    if len(limbs) != M:
        raise ValueError(f"K={K} at {bps} bits takes {M} limbs, got {len(limbs)}")
    if valid is None:
        sent = np.logical_and.reduce([x == _JAX_LIMB_SENT for x in limbs])
    else:
        sent = np.asarray(valid) == 0
    top_bits = bps * K - 32 * (M - 1)
    if top_bits < 32 and (limbs[0][~sent] >> np.uint32(top_bits)).any():
        raise ValueError(f"register wider than {bps * K} bits")
    words = _regroup([x.astype(np.uint64) for x in limbs], 32, KEY_BITS_MAX, n_words(K, bps))
    out = np.stack(words).astype(np.int64)
    out[:, sent] = SENTINEL
    return torch.from_numpy(out).to(device)


def words_to_jax(words: torch.Tensor, K: int, bps: int = 2):
    """The port's ``(W, n)`` words -> a tuple of JAX uint32 limb arrays,
    :data:`SENTINEL` rows back to all-ones."""
    w = words.detach().cpu().numpy().astype(np.int64)
    W = n_words(K, bps)
    if w.shape[0] != W:
        raise ValueError(f"K={K} at {bps} bits takes {W} words, got {w.shape[0]}")
    sent = w[0] == SENTINEL
    M = -(-bps * K // 32)
    limbs = _regroup([x.astype(np.uint64) for x in w], KEY_BITS_MAX, 32, M)
    return tuple(
        np.where(sent, np.uint32(_JAX_LIMB_SENT), x.astype(np.uint32)) for x in limbs
    )


def words_to_ints(words: np.ndarray) -> np.ndarray:
    """Real ``(W, n)`` words (no sentinel) -> the public object array of
    ``n`` Python-int registers, as the JAX package's ``mw_to_numpy``."""
    out = words[0].astype(object)
    for w in words[1:]:
        out = (out << KEY_BITS_MAX) | w.astype(object)
    return out
