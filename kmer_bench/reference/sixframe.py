"""The plain reference of the six-frame cells: exact six-frame amino-acid
k-mer count tables in plain PyTorch on the CPU, and the control that breaks
the counting guarantee.  A frozen copy of the repository's
``reference/sixframe_aa.py`` (a copy, not an import), so that the
benchmark's yardstick does not move with the repository.

It imports nothing of either k-mer package.  The six reading frames of a
nucleotide sequence are taken by codon lookup: frames 0, 1 and 2 of the
sequence and frames 0, 1 and 2 of its reverse complement, each translated
codon by codon with NCBI translation table 1 (:data:`TABLE_1`, written out
here).  A window is K consecutive codons of one frame; it is counted only
when all of its 3K bases are A, C, G, T or U, in either case, so windows
over N or IUPAC codes are skipped.  Stop codons are kept, as ``*``.

A window's key holds its amino acids 8 bits each, the earliest codon of
its frame in the highest bits; an amino acid's code is its index in
:data:`AA_CHARS` (``*`` is 26).  For K <= 7 a key fits one non-negative
int64; a wider one is held as ``ceil(K / 7)`` words of 7 amino acids (56
bits), word 0 the most significant.  A table is the distinct keys in
ascending order and how many windows hold each: :func:`count_table` gives
``np.uint64`` keys for K <= 7 and Python ints for K > 7 (the key's whole
value), with ``np.int64`` counts.

Departures from MMseqs2 (Steinegger and Soding 2017, ``createindex
--search-type 2``), whose prefilter indexes the six-frame translation of
a nucleotide database: one K (7) where MMseqs2 picks 6 or 7; one sequence
(a chromosome) in place of a target database; and every window of a frame
is counted, across stop codons too, where MMseqs2 first cuts each frame
into the open reading frames between stops.

The table is computed in blocks of anchors on threads (torch's CPU kernels
release the interpreter's lock).  A block owns the windows whose bases
start, on the forward strand, at its anchors, on both strands; their keys
are dealt into buckets by their first two amino acids.  Each bucket is then
sorted and counted on its own, and the buckets in order are the table.  The
block size does not change the table.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: the amino-acid alphabet: an amino acid's code is its index
AA_CHARS = "ARNDCQEGHILKMFPSTWYVOUBJZX*-"
#: NCBI translation table 1 (the standard code): codon -> amino acid
TABLE_1 = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L", "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*", "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L", "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q", "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M", "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K", "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V", "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E", "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

K_MIN, K_MAX = 1, 32
#: amino acids a word holds (56 bits)
WORD_AA = 7
#: anchors a thread computes at a time
BLOCK = 1 << 21
#: buckets: the first two amino acids' codes (each < 32)
N_BUCKETS = 32 * 32

#: a base's 2-bit code (A 0, C 1, G 2, T and U 3) and whether it is certain
_BASES = "ACGT"
_CODE = torch.zeros(256, dtype=torch.int64)
_GOOD = torch.zeros(256, dtype=torch.bool)
for _code, _letters in enumerate((b"Aa", b"Cc", b"Gg", b"TtUu")):
    for _b in _letters:
        _CODE[_b] = _code
        _GOOD[_b] = True
#: a codon's amino-acid code by the codon's 6 bits (first base highest)
_CODON_AA = torch.tensor(
    [AA_CHARS.index(TABLE_1[a + b + c]) for a in _BASES for b in _BASES for c in _BASES],
    dtype=torch.int64,
)


def _check_k(k: int) -> None:
    if not K_MIN <= k <= K_MAX:
        raise ValueError(f"the six-frame reference takes {K_MIN} <= K <= {K_MAX} (got K={k})")


def _as_bytes(seq) -> torch.Tensor:
    """ASCII bytes (a uint8 array or tensor) as a 1-D uint8 tensor."""
    return torch.as_tensor(seq, dtype=torch.uint8).reshape(-1)


def n_words(k: int) -> int:
    """Words of a K-mer's key."""
    return -(-k // WORD_AA)


def _strand_keys(codes: torch.Tensor, good: torch.Tensor, k: int, limit: int):
    """The valid windows of one strand's three frames that start before
    base ``limit``: ``(words, bucket)``, ``words`` ``(W, m)`` int64."""
    W = n_words(k)
    words, buckets = [], []
    for f in range(3):
        nc = (codes.shape[0] - f) // 3
        m = min(nc - k + 1, -(-(limit - f) // 3))
        if m <= 0:
            continue
        cod = codes[f : f + 3 * nc].view(nc, 3)
        aa = _CODON_AA[(cod[:, 0] << 4) | (cod[:, 1] << 2) | cod[:, 2]]
        bad = torch.zeros(nc + 1, dtype=torch.int64)
        bad[1:] = torch.cumsum((~good[f : f + 3 * nc].view(nc, 3).all(1)).long(), 0)
        valid = (bad[k : k + m] - bad[:m]) == 0
        w = torch.zeros((W, m), dtype=torch.int64)
        for j in range(k):
            up = k - 1 - j  # residues after codon j
            w[W - 1 - up // WORD_AA] |= aa[j : j + m] << (8 * (up % WORD_AA))
        second = aa[1 : 1 + m] if k > 1 else torch.zeros(m, dtype=torch.int64)
        words.append(w[:, valid])
        buckets.append(((aa[:m] << 5) | second)[valid])
    if not words:
        return torch.zeros((W, 0), dtype=torch.int64), torch.zeros(0, dtype=torch.int64)
    return torch.cat(words, 1), torch.cat(buckets)


def block_keys(seq, k: int, start: int, stop: int):
    """The valid windows, on both strands, whose bases start at a forward
    anchor in ``[start, stop)``: ``(words, bucket)``, ``words`` ``(W, m)``."""
    seq = _as_bytes(seq)
    sub = seq[start : min(stop + 3 * k - 1, seq.shape[0])].long()
    codes, good = _CODE[sub], _GOOD[sub]
    # the reverse complement's window at t covers forward bases ending at
    # len(sub) - t, so t < stop - start keeps those of the same anchors
    limit = stop - start
    fw = _strand_keys(codes, good, k, limit)
    rv = _strand_keys((3 - codes).flip(0), good.flip(0), k, limit)
    return torch.cat([fw[0], rv[0]], 1), torch.cat([fw[1], rv[1]])


def _block_buckets(seq: torch.Tensor, k: int, start: int, stop: int) -> list:
    """A block's keys dealt into buckets: one ``(W, m)`` tensor a bucket."""
    words, bucket = block_keys(seq, k, start, stop)
    order = torch.sort(bucket).indices
    sizes = torch.bincount(bucket, minlength=N_BUCKETS).tolist()
    return list(torch.split(words[:, order], sizes, 1))


def _runs(words: torch.Tensor):
    """Distinct columns of ``(W, n)`` words, sorted lexicographically (word
    0 first), and how often each occurs."""
    order = None
    for w in reversed(range(words.shape[0])):
        key = words[w] if order is None else words[w][order]
        idx = torch.sort(key, stable=True).indices
        order = idx if order is None else order[idx]
    n = words.shape[1]
    if n == 0:
        return words, torch.zeros(0, dtype=torch.int64)
    words = words[:, order]
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = (words[:, 1:] != words[:, :-1]).any(0)
    starts = torch.nonzero(first).flatten()
    return words[:, starts], torch.diff(torch.cat([starts, torch.tensor([n])]))


def _pool(n_blocks: int):
    """Threads for an input of several blocks; none for one block."""
    if n_blocks > 1:
        return ThreadPoolExecutor(os.cpu_count() or 1)
    return contextlib.nullcontext()


def count_words(seq, k: int, block: int = BLOCK):
    """The exact six-frame table of ``seq`` as words: ``(words, counts)``,
    ``words`` ``(W, n)`` int64 columns in ascending order."""
    _check_k(k)
    seq = _as_bytes(seq)
    n = seq.shape[0] - 3 * k + 1
    starts = range(0, max(n, 0), block)
    W = n_words(k)
    with _pool(len(starts)) as pool:
        run = pool.map if pool is not None else map
        blocks = list(run(lambda s: _block_buckets(seq, k, s, min(s + block, n)), starts))

        def bucket(j: int):
            if not blocks:
                return _runs(torch.zeros((W, 0), dtype=torch.int64))
            return _runs(torch.cat([b[j] for b in blocks], 1))

        tables = list(run(bucket, range(N_BUCKETS)))
    return torch.cat([w for w, _ in tables], 1), torch.cat([c for _, c in tables])


def as_keys(words: torch.Tensor):
    """``(W, n)`` words as the table's keys: ``np.uint64`` for one word,
    Python ints (the whole key) for more."""
    if words.shape[0] == 1:
        return words[0].numpy().astype(np.uint64)
    out = np.empty(words.shape[1], dtype=object)
    cols = words.T.tolist()
    for i, row in enumerate(cols):
        v = 0
        for x in row:
            v = (v << (8 * WORD_AA)) | x
        out[i] = v
    return out


def count_table(seq, k: int, block: int = BLOCK):
    """The exact six-frame amino-acid table of ``seq``: sorted ``keys``
    (``np.uint64`` for K <= 7, Python ints for K > 7) and ``np.int64``
    counts."""
    words, counts = count_words(seq, k, block)
    return as_keys(words), counts.numpy()


def window_keys(seq, pos: int, k: int):
    """The keys of the valid windows, on both strands, whose bases cover
    position ``pos``."""
    _check_k(k)
    return as_keys(block_keys(seq, k, max(pos - 3 * k + 1, 0), pos + 1)[0])


def seam_keys(seq, k: int, chunk: int):
    """The control of the counting guarantee "each window counted exactly
    once": the keys of both strands' windows at the first anchor of each
    chunk, were chunks of ``chunk`` bytes to overlap by 3K bytes instead of
    3K - 1, so that the window at each seam is counted twice.  Add them to
    the table to break it."""
    _check_k(k)
    seq = _as_bytes(seq)
    step = chunk - 3 * k
    seams = range(step, seq.shape[0] - 3 * k + 1, step)
    parts = [block_keys(seq, k, s, s + 1)[0] for s in seams]
    return as_keys(torch.cat(parts, 1) if parts else torch.zeros((n_words(k), 0), dtype=torch.int64))
