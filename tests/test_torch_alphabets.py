"""The port's alphabets and symbols (``kmers_tpu_torch.alphabets``,
``kmers_tpu_torch.symbols``) and ``ops.encode.encode_table`` against the
JAX package's ``kmers_tpu.alphabets`` and ``kmers_tpu.ops.encode``: the
same ASCII tables, codes, symbols and errors, and ``encode_table`` equal
to the reference's over all 256 bytes for every alphabet class."""

import numpy as np
import pytest
import torch

import kmers_tpu as jkt
from kmers_tpu.ops.encode import encode_table as jax_encode_table
import kmers_tpu_torch as tkt
from kmers_tpu_torch import alphabets as tal
from kmers_tpu_torch import symbols as tsym
from kmers_tpu_torch.ops import classify_2bit, encode_table

NAMES = ["DNAAlphabet2", "RNAAlphabet2", "DNAAlphabet4", "RNAAlphabet4", "AminoAcidAlphabet"]
ALL_BYTES = np.arange(256, dtype=np.uint8)


@pytest.mark.parametrize("name", NAMES)
def test_ascii_tables_and_widths_match_reference(name):
    got, want = getattr(tal, name)(), getattr(jkt, name)()
    assert got.bits_per_symbol == want.bits_per_symbol
    assert got.ascii_table.dtype == np.uint8
    assert np.array_equal(got.ascii_table, want.ascii_table)
    assert got.is_complete == want.is_complete
    assert repr(got) == repr(want) == name
    assert got is getattr(tal, name)() and got == getattr(tal, name)()
    assert [got.ascii_encode(b) for b in range(256)] == [want.ascii_encode(b) for b in range(256)]


@pytest.mark.parametrize("name", NAMES)
def test_symbols_encode_and_decode_match_reference(name):
    got, want = getattr(tal, name)(), getattr(jkt, name)()
    assert [(s.code, s.char, repr(s)) for s in got.symbols] == [(s.code, s.char, repr(s)) for s in want.symbols]
    for s in want.symbols:
        assert got.encode(s.char) == want.encode(s.char)
        assert got.decode(want.encode(s.char)).char == s.char
    for c in "acgtunrymkswbdhv*-xz!@ ":
        try:
            expect = want.encode(c)
        except jkt.EncodeError:
            with pytest.raises(tsym.EncodeError):
                got.encode(c)
        else:
            assert got.encode(c) == expect


def test_nucleotides_convert_and_amino_acids_do_not():
    assert tsym.DNA.coerce(tsym.RNA.U) is tsym.DNA.T and tsym.RNA.coerce(tsym.DNA.T) is tsym.RNA.U
    assert tal.RNAAlphabet2().encode(tsym.DNA.G) == 2
    with pytest.raises(tsym.EncodeError):
        tsym.AminoAcid.coerce(tsym.DNA.A)
    with pytest.raises(tsym.EncodeError):
        tal.DNAAlphabet2().encode("N")  # ambiguous: no 2-bit code
    assert tsym.AminoAcid.Term.code == jkt.AminoAcid.Term.code == 0x1A
    assert tsym.DNA.Gap.code == 0 and tsym.DNA.N.code == 0xF
    assert isinstance(tsym.DNA.A, tsym.NucleicAcid) and isinstance(tsym.RNA.A, tkt.NucleicAcid)
    assert tkt.EncodeError is tsym.EncodeError and issubclass(tsym.EncodeError, ValueError)
    with pytest.raises(AttributeError):
        tsym.DNA.A.code = 3


def test_parametric_alphabets_and_char_alphabet():
    for bits in (2, 4):
        assert repr(tal.DNAAlphabet(bits)) == repr(jkt.DNAAlphabet(bits))
        assert repr(tal.RNAAlphabet(bits)) == repr(jkt.RNAAlphabet(bits))
    for fn in (tal.DNAAlphabet, tal.RNAAlphabet):
        with pytest.raises(ValueError):
            fn(8)
    ch = tal.CharAlphabet()
    assert ch.bits_per_symbol == 32 and not ch.is_complete and ch.ascii_table is None
    assert ch.encode("é") == jkt.CharAlphabet().encode("é") and ch.decode(0x263A) == "☺"
    with pytest.raises(tsym.EncodeError):
        ch.encode("ab")
    with pytest.raises(tsym.EncodeError):
        ch.ascii_encode(65)
    with pytest.raises(tsym.EncodeError):
        tal.AminoAcidAlphabet().decode(0x1C)


def test_skipping_lut_matches_reference_and_classify_2bit():
    assert np.array_equal(tal.ASCII_SKIPPING_LUT, jkt.ASCII_SKIPPING_LUT)
    assert not tal.ASCII_SKIPPING_LUT.flags.writeable
    codes, certain, ambig = classify_2bit(torch.from_numpy(ALL_BYTES))
    lut = tal.ASCII_SKIPPING_LUT
    assert np.array_equal(certain.numpy(), lut < 4)
    assert np.array_equal(ambig.numpy(), lut == 0xF0)
    assert np.array_equal(codes.numpy()[lut < 4], lut[lut < 4])
    assert tal.TWOBIT_ALPHABETS == (tal.DNAAlphabet2, tal.RNAAlphabet2)
    assert tal.FOURBIT_ALPHABETS == (tal.DNAAlphabet4, tal.RNAAlphabet4)


@pytest.mark.parametrize("name", NAMES)
def test_encode_table_matches_reference_over_all_bytes(name):
    data = np.concatenate([ALL_BYTES, np.random.default_rng(3).integers(0, 256, 1000, dtype=np.uint8)])
    codes, valid = encode_table(torch.from_numpy(data), getattr(tal, name))
    jcodes, jvalid = jax_encode_table(data, getattr(jkt, name))
    assert codes.dtype == torch.int64 and valid.dtype == torch.bool
    assert np.array_equal(codes.numpy(), np.asarray(jcodes).astype(np.int64))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.array_equal(codes.numpy()[:256], getattr(tal, name)().ascii_table.astype(np.int64))


def test_encode_table_rejects_an_alphabet_without_a_table():
    with pytest.raises(KeyError):
        encode_table(torch.from_numpy(ALL_BYTES), tal.CharAlphabet)
    with pytest.raises(KeyError):
        jax_encode_table(ALL_BYTES, jkt.CharAlphabet)


def test_encode_table_feeds_the_4bit_windows():
    # 4-bit codes of IUPAC DNA, then canonical 4-bit windows: the input the
    # reference's tests make for kernel K6's 4-bit path
    from kmers_tpu.ops import canonical_windows_4bit_from_codes as jax_canonical_4bit
    from kmers_tpu_torch.ops import canonical_windows_4bit_from_codes

    data = np.frombuffer(b"ACGTNRYKMacgtn-SWBDHV" * 20, np.uint8).copy()
    codes, valid = encode_table(torch.from_numpy(data), tal.DNAAlphabet4)
    assert bool(valid.all())
    got = canonical_windows_4bit_from_codes(codes, 9)
    hi, lo = jax_canonical_4bit(np.asarray(jax_encode_table(data, jkt.DNAAlphabet4)[0]), 9)
    want = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    assert np.array_equal(got.numpy().view(np.uint64), want)
