"""The port's genetic codes (``kmers_tpu_torch/genetic_codes.py``) and
codon-set masks (``kmers_tpu_torch/revtrans.py``), bit-exact against the
JAX package's ``genetic_codes.py``, ``symbols.py``, the six-frame kernels'
``sixframe_tbl16`` and ``revtrans.ReverseGeneticCode``."""

import numpy as np
import pytest

from kmers_tpu import genetic_codes as jgc
from kmers_tpu.ops.pallas.sixframe_kernel import sixframe_tbl16 as jax_tbl16
from kmers_tpu.revtrans import ReverseGeneticCode
from kmers_tpu.symbols import AminoAcid
from kmers_tpu_torch import genetic_codes as tgc
from kmers_tpu_torch.revtrans import codon_set_masks


def test_amino_acid_alphabet_matches_jax():
    assert [AminoAcid.from_code(i).char for i in range(len(tgc.AA_CHARS))] == list(tgc.AA_CHARS)


def test_trans_table_numbers_match_jax():
    assert sorted(tgc.ncbi_trans_table) == sorted(jgc.ncbi_trans_table)
    assert tgc.ncbi_trans_table[1] is tgc.standard_genetic_code


@pytest.mark.parametrize("number", sorted(jgc.ncbi_trans_table))
def test_trans_table_matches_jax(number):
    got, want = tgc.ncbi_trans_table[number], jgc.ncbi_trans_table[number]
    assert got.name == want.name
    assert got.tbl.dtype == np.uint8 and np.array_equal(got.tbl, want.tbl)
    assert all(got.aa_code(c) == want.aa_code(c) for c in range(64))


@pytest.mark.parametrize("number", [1, 2, 6, 25])
def test_sixframe_tbl16_matches_jax(number):
    want = jax_tbl16(bytes(jgc.ncbi_trans_table[number].tbl.tobytes()))
    assert tgc.sixframe_tbl16(tgc.ncbi_trans_table[number]) == want


@pytest.mark.parametrize("number", [1, 5])
def test_codon_set_masks_match_reverse_genetic_code(number):
    want = [s.x for s in ReverseGeneticCode(jgc.ncbi_trans_table[number]).sets]
    got = codon_set_masks(tgc.ncbi_trans_table[number])
    assert len(got) == 27 and list(got) == want


def test_genetic_code_is_immutable_and_checked():
    code = tgc.standard_genetic_code
    with pytest.raises(AttributeError):
        code.name = "x"
    with pytest.raises(ValueError):
        code.tbl[0] = 1
    with pytest.raises(ValueError):
        tgc.GeneticCode("short", "FFLL")
