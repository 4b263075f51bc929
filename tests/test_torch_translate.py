"""The port's translation and reverse-translation ops
(``kmers_tpu_torch/ops/translate_ops.py``, ``ops/revtrans_ops.py``),
bit-exact against ``kmers_tpu/ops/translate_ops.py`` and
``ops/revtrans_ops.py`` on random 2-bit streams and amino-acid codes,
under two genetic codes."""

import numpy as np
import pytest
import torch

from kmers_tpu import genetic_codes as jgc
from kmers_tpu.ops import revtrans_ops as jrt
from kmers_tpu.ops import translate_ops as jtr
from kmers_tpu.revtrans import ReverseGeneticCode
from kmers_tpu_torch import genetic_codes as tgc
from kmers_tpu_torch.ops import revtrans_ops as trt
from kmers_tpu_torch.ops import translate_ops as ttr

LENGTHS = [0, 1, 2, 3, 8, 47, 100]
CODES = [1, 2]


def _codes(L, seed):
    return np.random.default_rng(seed).integers(0, 4, L).astype(np.uint32)


def _u64(hi, lo):
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


@pytest.mark.parametrize("number", CODES)
@pytest.mark.parametrize("L", LENGTHS)
def test_translate_and_six_frames_match_jax(L, number):
    c = _codes(L, L + number)
    tcode, jcode = tgc.ncbi_trans_table[number], jgc.ncbi_trans_table[number]
    got = ttr.translate_codes(torch.from_numpy(c.astype(np.int64)), tcode)
    assert got.tolist() == np.asarray(jtr.translate_codes(c, jcode)).tolist()
    got6 = ttr.six_frame_codes(torch.from_numpy(c.astype(np.int64)), tcode)
    want6 = jtr.six_frame_codes(c, jcode)
    assert len(got6) == 6
    for g, w in zip(got6, want6):
        assert g.tolist() == np.asarray(w).tolist()


@pytest.mark.parametrize("K", range(1, 9))
def test_aa_kmer_windows_match_jax(K):
    rng = np.random.default_rng(K)
    aa = rng.integers(0, 28, 90).astype(np.uint32)
    got = ttr.aa_kmer_windows(torch.from_numpy(aa.astype(np.int64)), K)
    hi, lo = jtr.aa_kmer_windows(aa, K)
    # K = 8 fills 64 bits: the int64 is the raw pattern
    assert np.array_equal(got.numpy().view(np.uint64), _u64(hi, lo)[: got.shape[0]])
    assert got.shape[0] == 90 - K + 1


@pytest.mark.parametrize("number", CODES)
@pytest.mark.parametrize("K,L", [(1, 5), (3, 40), (8, 100)])
def test_six_frame_aa_kmers_match_jax(K, L, number):
    c = _codes(L, 3 * K + L)
    got = ttr.six_frame_aa_kmers(torch.from_numpy(c.astype(np.int64)), K, tgc.ncbi_trans_table[number])
    want = jtr.six_frame_aa_kmers(c, K, jgc.ncbi_trans_table[number])
    assert len(got) == 6
    for g, (hi, lo) in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint64), _u64(hi, lo)[: g.shape[0]])


@pytest.mark.parametrize("number", CODES)
def test_reverse_translate_matches_jax(number):
    aa = np.random.default_rng(number).integers(0, 27, 500)
    jcode = ReverseGeneticCode(jgc.ncbi_trans_table[number])
    hi, lo = jrt.reverse_translate_codes(aa, jcode)
    got = trt.reverse_translate_codes(torch.from_numpy(aa), tgc.ncbi_trans_table[number])
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().view(np.uint64), _u64(hi, lo))
    thi, tlo = jrt.codon_set_table(jcode)
    table = trt.codon_set_table(tgc.ncbi_trans_table[number], device="cpu")
    assert np.array_equal(table.numpy().view(np.uint64), _u64(thi, tlo))


@pytest.mark.parametrize("bad", [27, 28, -1])
def test_reverse_translate_rejects_gap_and_out_of_range(bad):
    aa = np.array([0, 5, bad])
    with pytest.raises(ValueError, match="Cannot reverse translate"):
        jrt.reverse_translate_codes(aa)
    with pytest.raises(ValueError, match="Cannot reverse translate"):
        trt.reverse_translate_codes(aa)


def test_codon_set_table_defaults_to_the_card():
    import inspect

    assert inspect.signature(trt.codon_set_table).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        # no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            trt.codon_set_table(tgc.ncbi_trans_table[2])
