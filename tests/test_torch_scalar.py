"""The port's scalar plane against the JAX package's, bit for bit.

The same inputs, made from a numpy seed, go through ``kmers_tpu`` and
``kmers_tpu_torch``: ``Kmer`` of every alphabet at K = 1 to 116,
``Seq``, the iterators, the function API, translation in every NCBI code,
reverse translation, construction, random k-mers under the same seeds,
and the errors of bad input.  Every answer is an integer or a string, so
the tolerance is none: each result is reduced by :func:`norm` to plain
Python values (class names, ints, strings) and the two must be equal,
errors included (class name and message)."""

import ast
from pathlib import Path

import numpy as np
import pytest

import kmers_tpu as jk
import kmers_tpu_torch as tk
from kmers_tpu import pipelines as jpipe
from kmers_tpu_torch import convert
from kmers_tpu_torch import pipelines as tpipe
from kmers_tpu_torch.genetic_codes import sixframe_tbl16
from kmers_tpu_torch.revtrans import codon_set_masks

ROOT = Path(__file__).resolve().parents[1]

KS = [1, 9, 31, 32, 33, 63, 64, 116]
ALPHABETS = ["DNAAlphabet2", "DNAAlphabet4", "RNAAlphabet2", "RNAAlphabet4",
             "AminoAcidAlphabet", "CharAlphabet"]

#: per alphabet: the characters it encodes and those that a sequence
#: "with ambiguous codes, gaps and lowercase" adds (for 2-bit alphabets
#: these raise, or restart a window in the skipping iterators)
CERTAIN = {
    "DNAAlphabet2": "ACGTacgt",
    "RNAAlphabet2": "ACGUacgu",
    "DNAAlphabet4": "ACGTacgt",
    "RNAAlphabet4": "ACGUacgu",
    "AminoAcidAlphabet": "ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy",
    "CharAlphabet": "ACGTαβγ€x",
}
EXTRA = {
    "DNAAlphabet2": "NRYKM-nrs",
    "RNAAlphabet2": "NRYKM-nrs",
    "DNAAlphabet4": "NRYKMSWBDHV-nrb",
    "RNAAlphabet4": "NRYKMSWBDHV-nrb",
    "AminoAcidAlphabet": "OUBJZX*-bjzx",
    "CharAlphabet": "-*Ω",
}


def norm(x):
    """Plain Python values of a result of either package."""
    if isinstance(x, (jk.Kmer, tk.Kmer)):
        return ("Kmer", type(x.alphabet).__name__, x.K, x.value, str(x), repr(x), hash(x))
    if isinstance(x, (jk.Seq, tk.Seq)):
        return ("Seq", type(x.alphabet).__name__, x.codes.dtype.str, x.codes.tobytes(), str(x))
    if isinstance(x, (jk.CodonSet, tk.CodonSet)):
        return ("CodonSet", x.x, repr(x))
    if isinstance(x, (jk.DNA, jk.RNA, jk.AminoAcid, tk.DNA, tk.RNA, tk.AminoAcid)):
        return (type(x).__name__, x.code, repr(x))
    if isinstance(x, (jk.Alphabet, tk.Alphabet)):
        return ("Alphabet", type(x).__name__)
    if isinstance(x, (jk.KmerType, tk.KmerType)):
        return ("KmerType", repr(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, [int(v) for v in x.reshape(-1)])
    if isinstance(x, np.generic):
        return (type(x).__name__, int(x))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [norm(v) for v in x])
    if isinstance(x, type):
        return ("type", x.__name__)
    return x


def outcome(fn, pkg):
    """``("ok", norm(fn(pkg)))`` or the error's class name and message."""
    try:
        return ("ok", norm(fn(pkg)))
    except Exception as e:  # noqa: BLE001 - every error is compared
        return ("err", type(e).__name__, str(e))


def same(fn):
    """``fn`` gives the same outcome in both packages; returns it."""
    got, want = outcome(fn, tk), outcome(fn, jk)
    assert got == want
    return got


def seq(rng, chars, n):
    return "".join(chars[i] for i in rng.integers(0, len(chars), n))


def _alpha(pkg, name):
    return getattr(pkg, name)()


# ---------------------------------------------------------------- Kmer


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", ALPHABETS)
def test_kmer_of_every_alphabet(name, K):
    rng = np.random.default_rng([K, ALPHABETS.index(name)])
    s = seq(rng, CERTAIN[name], K)
    nuc = name != "AminoAcidAlphabet" and name != "CharAlphabet"
    sym = CERTAIN[name][int(rng.integers(len(CERTAIN[name])))]

    def k(pkg):
        return pkg.Kmer(_alpha(pkg, name), s)

    assert same(k)[0] == "ok"
    same(lambda p: k(p).words)
    same(lambda p: p.derive_words(_alpha(p, name), K, k(p).value))
    same(lambda p: p.n_words(_alpha(p, name), K))
    same(lambda p: (k(p).nsize, k(p).capacity, k(p).n_unused, k(p).bits_unused))
    same(lambda p: p.fx_hash(k(p)))
    same(lambda p: p.fx_hash(k(p), 0x1234_5678_9ABC_DEF0))
    same(lambda p: p.as_integer(k(p)))
    same(lambda p: p.from_integer(k(p), k(p).value + (1 << (K * k(p).bps))))
    same(lambda p: p.derive_type(_alpha(p, name), K).from_integer(k(p).value))
    same(lambda p: p.derive_type(_alpha(p, name), K).zero())
    same(lambda p: (k(p)[0], k(p)[-1], k(p)[1:K - 1], k(p)[::2], k(p)[[0, K - 1]]))
    same(lambda p: [k(p).push(sym), k(p).push_first(sym), k(p).shift(sym), k(p).shift_first(sym)])
    same(lambda p: [k(p).pop(), k(p).pop_first(), k(p).setindex(K // 2, sym)])
    same(lambda p: (p.reverse(k(p)), list(k(p)), p.Kmer(_alpha(p, name), p.Seq(_alpha(p, name), s))))
    same(lambda p: sorted([k(p), k(p).shift(sym), k(p).reverse()]))
    same(lambda p: k(p).to_seq())
    same(lambda p: p.Kmer(_alpha(p, name), s + s[:1]))  # K + 1 symbols
    same(lambda p: p.Kmer(_alpha(p, name), s, K=K + 1))  # length check
    if nuc:
        for verb in ("complement", "reverse_complement", "canonical", "iscanonical"):
            same(lambda p: getattr(p, verb)(k(p)))
        same(lambda p: k(p).count_gc())
        other = "DNAAlphabet4" if "2" in name else "DNAAlphabet2"
        same(lambda p: k(p).recode(_alpha(p, other)))
        same(lambda p: k(p) == p.Kmer(_alpha(p, other), s))
    else:
        same(lambda p: p.complement(k(p)))


@pytest.mark.parametrize("name", ALPHABETS)
def test_kmer_of_ambiguous_gapped_lowercase_input(name):
    rng = np.random.default_rng(ALPHABETS.index(name))
    for K in KS:
        s = seq(rng, CERTAIN[name] + EXTRA[name], K)
        same(lambda p: p.Kmer(_alpha(p, name), s))
        same(lambda p: p.Kmer(_alpha(p, name), s.encode("utf-8")))
        same(lambda p: p.Seq(_alpha(p, name), s))


# ------------------------------------------------------------ iterators

ITERATORS = {
    "FwKmers": lambda p, A, K, s: p.FwKmers(A, K, s),
    "FwRvIterator": lambda p, A, K, s: p.FwRvIterator(A, K, s),
    "CanonicalKmers": lambda p, A, K, s: p.CanonicalKmers(A, K, s),
    "UnambiguousKmers": lambda p, A, K, s: p.UnambiguousKmers(A, K, s),
    "SpacedKmers-3": lambda p, A, K, s: p.SpacedKmers(A, K, s, 3),
    "SpacedKmers-K+2": lambda p, A, K, s: p.SpacedKmers(A, K, s, K + 2),
}


@pytest.mark.parametrize("source", ["str", "Seq", "bytes"])
@pytest.mark.parametrize("it", list(ITERATORS))
@pytest.mark.parametrize("name", ALPHABETS)
def test_iterators(name, it, source):
    """Every iterator by value, position and text, over certain input and
    over input with ambiguous codes, gaps and lowercase, at every K."""
    rng = np.random.default_rng([ALPHABETS.index(name), list(ITERATORS).index(it)])
    for K in KS:
        for chars in (CERTAIN[name], CERTAIN[name] + EXTRA[name]):
            s = seq(rng, chars, K + 40)

            def src(p):
                if source == "Seq":
                    # a 4-bit sequence of a 2-bit alphabet's input: the recoding paths
                    return p.Seq(_alpha(p, name.replace("2", "4")), s)
                return s.encode("utf-8") if source == "bytes" else s

            same(lambda p: list(ITERATORS[it](p, _alpha(p, name), K, src(p))))
            same(lambda p: len(ITERATORS[it](p, _alpha(p, name), K, src(p))))


@pytest.mark.parametrize("K", KS)
def test_shorthand_iterators_and_codons(K):
    rng = np.random.default_rng(K)
    dna = seq(rng, "ACGTacgtNRY-", K + 60)
    rna = dna.replace("T", "U").replace("t", "u")
    aa = seq(rng, CERTAIN["AminoAcidAlphabet"] + "XBJ*-", K + 60)
    clean = seq(rng, "ACGT", K + 60)
    for fn in (
        lambda p: list(p.FwDNAMers(K, clean)),
        lambda p: list(p.FwRNAMers(K, clean.replace("T", "U"))),
        lambda p: list(p.FwAAMers(K, aa)),
        lambda p: list(p.CanonicalDNAMers(K, clean)),
        lambda p: list(p.CanonicalRNAMers(K, clean)),
        lambda p: list(p.UnambiguousDNAMers(K, dna)),
        lambda p: list(p.UnambiguousRNAMers(K, rna)),
        lambda p: list(p.SpacedDNAMers(K, 2, clean)),
        lambda p: list(p.SpacedRNAMers(K, K, rna)),
        lambda p: list(p.SpacedAAMers(K, 5, aa)),
        lambda p: list(p.each_codon(p.DNA, clean)),
        lambda p: list(p.each_codon(p.RNA, rna)),
        lambda p: list(p.each_codon(p.Seq(p.DNAAlphabet4, dna))),
        lambda p: list(p.FwDNAMers(K, dna)),  # raises at the first N
    ):
        same(fn)


# ----------------------------------------------------- translation


CODES = sorted(jk.ncbi_trans_table)


@pytest.mark.parametrize("number", CODES)
def test_translate_every_ncbi_code(number):
    rng = np.random.default_rng(number)
    four = seq(rng, "ACGTACGTACGTNRYKMSWBDHV", 3 * 50)
    two = seq(rng, "ACGT", 3 * 50)
    gap = four[:30] + "-" + four[31:]
    for s, name in ((four, "DNAAlphabet4"), (two, "DNAAlphabet2"), (gap, "DNAAlphabet4"),
                    (four.replace("T", "U"), "RNAAlphabet4"), (two[:-1], "DNAAlphabet2")):
        for allow in (True, False):
            for alt in (False, True):
                kw = lambda p: dict(code=p.ncbi_trans_table[number], allow_ambiguous_codons=allow,
                                    alternative_start=alt)
                same(lambda p: p.translate(p.Seq(_alpha(p, name), s), **kw(p)))
                same(lambda p: p.translate(p.Kmer(_alpha(p, name), s[:63]), **kw(p)))
    # the code's table, its named object and the codons one by one
    assert np.array_equal(tk.ncbi_trans_table[number].tbl, jk.ncbi_trans_table[number].tbl)
    assert tk.ncbi_trans_table[number].name == jk.ncbi_trans_table[number].name
    same(lambda p: [p.ncbi_trans_table[number][c] for c in range(64)])
    same(lambda p: [p.ncbi_trans_table[number][p.RNACodon(c)] for c in ("AUG", "UGA", "UAG")])


def test_named_codes_are_the_table_entries():
    from kmers_tpu import genetic_codes as jgc
    from kmers_tpu_torch import genetic_codes as tgc

    names = [n for n in vars(jgc) if n.endswith("_genetic_code")]
    assert len(names) == len(CODES) + 1  # the reference's typo'd alias too
    for n in names:
        got, want = getattr(tgc, n), getattr(jgc, n)
        assert got.name == want.name and np.array_equal(got.tbl, want.tbl)
    assert {id(getattr(tgc, n)) for n in names} == {id(c) for c in tgc.ncbi_trans_table.values()}


def test_ambiguous_codons_and_unambiguous_codon():
    from kmers_tpu import genetic_codes as jgc
    from kmers_tpu_torch import genetic_codes as tgc

    rna = "ACGUMRWSYKVHDBN"
    for number in CODES:
        for a in rna:
            for b in "ACGUN":
                for c in rna:
                    for allow in (True, False):
                        same(lambda p: (jgc if p is jk else tgc).try_translate_ambiguous_codon(
                            p.ncbi_trans_table[number], p.RNA.from_char(a), p.RNA.from_char(b),
                            p.RNA.from_char(c), allow))
    assert [tgc.unambiguous_codon(a, b, c) for a in range(5) for b in range(4) for c in range(4)] == [
        jgc.unambiguous_codon(a, b, c) for a in range(5) for b in range(4) for c in range(4)]


def test_sixframe_table_unchanged():
    """``GeneticCode.tbl``, which K4 and K5 read through ``sixframe_tbl16``,
    is the JAX package's in every code."""
    for number in CODES:
        jtbl = jk.ncbi_trans_table[number].tbl
        want = []
        for c in range(64):
            rc = (((c & 3) ^ 3) << 4) | ((((c >> 2) & 3) ^ 3) << 2) | (((c >> 4) & 3) ^ 3)
            want.append(int(jtbl[c]) | (int(jtbl[rc]) << 8))
        assert sixframe_tbl16(tk.ncbi_trans_table[number]) == tuple(want)


# ------------------------------------------------ reverse translation


@pytest.mark.parametrize("number", CODES)
def test_reverse_translate_every_code(number):
    """``codon_set_masks`` (the device op's) equals the masks of the
    ``ReverseGeneticCode`` codon sets of both packages, and reverse
    translation of amino-acid kmers, sequences and symbols agrees."""
    t_rev = tk.ReverseGeneticCode(tk.ncbi_trans_table[number])
    j_rev = jk.ReverseGeneticCode(jk.ncbi_trans_table[number])
    masks = codon_set_masks(tk.ncbi_trans_table[number])
    assert masks == tuple(s.x for s in t_rev.sets) == tuple(s.x for s in j_rev.sets)
    rng = np.random.default_rng(100 + number)
    s = seq(rng, "ARNDCQEGHILKMFPSTWYVOUBJZX*", 40)

    def rev(p):
        return t_rev if p is tk else j_rev

    same(lambda p: p.reverse_translate(p.AAKmer(s), rev(p)))
    same(lambda p: p.reverse_translate(p.Seq(p.AminoAcidAlphabet, s), rev(p)))
    same(lambda p: [p.reverse_translate(c, rev(p)) for c in s])
    same(lambda p: p.reverse_translate_into(["x"], p.AAKmer(s), rev(p)))
    same(lambda p: p.reverse_translate(p.AminoAcid.Gap, rev(p)))  # raises
    same(lambda p: [(aa, cs) for aa, cs in rev(p)])
    same(lambda p: (len(rev(p)), repr(rev(p))))


def test_codon_sets():
    for fn in (
        lambda p: p.CodonSet(["AUG", "UGA", p.DNACodon("TTT")]),
        lambda p: list(p.CodonSet(["AUG", "UGA", "GGC"])),
        lambda p: p.CodonSet(["AUG"]).push("UGG").delete("AUG"),
        lambda p: p.delete(p.CodonSet(["AUG", "UGG"]), "UGG"),
        lambda p: (p.CodonSet(["AUG", "CCC"]) | p.CodonSet(["CCC"]),
                   p.CodonSet(["AUG", "CCC"]) & p.CodonSet(["CCC"]),
                   p.CodonSet(["AUG", "CCC"]) - p.CodonSet(["CCC"]),
                   p.CodonSet(["AUG", "CCC"]) ^ p.CodonSet(["CCC", "GGG"])),
        lambda p: ("AUG" in p.rev_standard_genetic_code["M"], "UAA" in p.rev_standard_genetic_code["M"]),
        lambda p: p.CodonSet(["AU"]),  # raises
    ):
        same(fn)


# -------------------------------------------------------- construction


@pytest.mark.parametrize("target", ALPHABETS[:5])
def test_recoding_schemes_and_shift(target):
    rng = np.random.default_rng(ALPHABETS.index(target))
    s = seq(rng, "ACGT" if "Amino" not in target else "ACDEFGHIK", 40)
    for source in ("str", "bytes", "ndarray", *ALPHABETS[:5]):
        def src(p):
            if source == "str":
                return s
            if source == "bytes":
                return s.encode()
            if source == "ndarray":
                return np.frombuffer(s.encode(), np.uint8)
            return p.Seq(_alpha(p, source), s if "Amino" not in source or "Amino" in target
                         else "ACDEFGHIK")

        same(lambda p: type(p.recoding_scheme(_alpha(p, target), src(p))).__name__)
        same(lambda p: type(p.recoding_scheme(_alpha(p, target), p.Kmer(_alpha(p, source), s)
                                              if source in ALPHABETS else src(p))).__name__)

        def extract(p, start=3, K=20):
            A = _alpha(p, target)
            return p.unsafe_extract(p.recoding_scheme(A, src(p)), A, K, src(p), start)

        same(extract)
        same(lambda p: p.unsafe_shift_from(
            p.recoding_scheme(_alpha(p, target), src(p)), extract(p), src(p), 25, 7))
        same(lambda p: p.shift_encoding(extract(p), 1))


def test_checked_mode_bounds():
    from kmers_tpu.utils import checked as jchecked
    from kmers_tpu_torch.utils import checked as tchecked

    for p, ctx in ((tk, tchecked), (jk, jchecked)):
        A = p.DNAAlphabet2()
        with ctx():
            with pytest.raises(IndexError) as e:
                p.unsafe_extract(p.AsciiEncode(), A, 5, "ACGT", 0)
        assert "out of bounds" in str(e.value)


# -------------------------------------------------------------- random


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", ALPHABETS)
def test_random_kmers_same_seed(name, K):
    seed = 7 * K + ALPHABETS.index(name)
    same(lambda p: p.rand_kmer(_alpha(p, name), K, rng=seed))
    same(lambda p: p.rand_kmers(_alpha(p, name), K, 9, rng=seed))
    same(lambda p: p.rand_kmers_mw(_alpha(p, name), K, 9, rng=seed))
    same(lambda p: p.rand_kmers(getattr(p, name), K, 3, rng=np.random.default_rng(seed)))
    same(lambda p: [p.rand_symbol(_alpha(p, name), np.random.default_rng(seed)) for _ in range(3)])
    same(lambda p: p.rand_from_kmer(p.rand_kmer(_alpha(p, name), K, rng=seed), rng=seed))


@pytest.mark.parametrize("K", [9, 31, 32, 47, 63, 100])
def test_rand_kmers_mw_round_trip_to_device_words(K):
    """The (n, M) uint32 limbs of ``rand_kmers_mw`` are the JAX package's
    layout: ``convert.words_from_jax`` gives the port's device words of the
    same registers as ``rand_kmers``."""
    limbs = tk.rand_kmers_mw(tk.DNAAlphabet2, K, 50, rng=K)
    vals = tk.rand_kmers(tk.DNAAlphabet2, K, 50, rng=K)
    words = convert.words_from_jax(list(limbs.T), K, device="cpu").numpy()
    W = convert.n_words(K)
    mask = (1 << convert.KEY_BITS_MAX) - 1
    want = [[(int(v) >> (convert.KEY_BITS_MAX * (W - 1 - w))) & mask for v in vals] for w in range(W)]
    assert words.tolist() == want
    assert np.array_equal(limbs, jk.rand_kmers_mw(jk.DNAAlphabet2, K, 50, rng=K))


# -------------------------------------------------------------- errors


def test_encode_error_scalar():
    """``EncodeError`` carries the alphabet object and formats a byte
    as the reference does."""
    for fn in (lambda p: p.DNAKmer("AXG"), lambda p: p.DNAKmer(b"AC\xc8"),
               lambda p: p.Kmer(p.AminoAcidAlphabet, "AK$"), lambda p: p.RNAKmer("ACGT"),
               lambda p: p.Seq(p.DNAAlphabet4, "ACZ"), lambda p: p.DNA.from_char("Z"),
               lambda p: p.DNAAlphabet2().encode(p.DNA.N), lambda p: p.mer("ACG", "q"),
               lambda p: list(p.CanonicalDNAMers(3, "ACGTN"))):
        assert same(fn)[0] == "err"
    for s in ("AXG", b"AC\xc8"):
        with pytest.raises(tk.EncodeError) as got:
            tk.DNAKmer(s)
        with pytest.raises(jk.EncodeError) as want:
            jk.DNAKmer(s)
        assert str(got.value) == str(want.value)
        assert type(got.value.alphabet) is tk.DNAAlphabet2
        assert got.value.value == want.value.value
    assert str(tk.EncodeError(tk.DNAAlphabet2(), 65)) == "cannot encode 0x41 (char 'A') in DNAAlphabet2"


@pytest.mark.parametrize("call", ["canonical_count_bytes", "extract_kmers", "minhash_sketch"])
def test_encode_error_device_plane(call):
    """The device plane's ``EncodeError`` (on the CPU): the same message and an
    alphabet of the port's ``DNAAlphabet2``."""
    data = b"ACGTACGTNACGT"
    if call == "canonical_count_bytes":
        run_t = lambda: tpipe.canonical_count_bytes(data, tpipe.CountConfig(K=5, skip_ambiguous=False),
                                                    device="cpu")
        run_j = lambda: jpipe.canonical_count_bytes(data, jpipe.CountConfig(K=5, skip_ambiguous=False))
    elif call == "extract_kmers":
        run_t = lambda: tpipe.extract_kmers(data, K=5, skip_ambiguous=False, device="cpu")
        run_j = lambda: jpipe.extract_kmers(data, K=5, skip_ambiguous=False)
    else:
        run_t = lambda: tpipe.minhash_sketch(data + b"X", K=5, s=3, device="cpu")
        run_j = lambda: jpipe.minhash_sketch(data + b"X", K=5, s=3)
    with pytest.raises(tk.EncodeError) as got:
        run_t()
    with pytest.raises(jk.EncodeError) as want:
        run_j()
    assert str(got.value) == str(want.value)
    assert type(got.value.alphabet) is tk.DNAAlphabet2
    assert type(want.value.alphabet).__name__ == "DNAAlphabet2"


# ----------------------------------------------------------------- API


def _reference_top_level_names():
    tree = ast.parse((ROOT / "kmers_tpu" / "__init__.py").read_text())
    return [a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom) for a in n.names]


def test_exports_every_reference_name():
    names = _reference_top_level_names()
    assert len(names) > 60
    missing = [n for n in names if not hasattr(tk, n)]
    assert not missing, missing
    assert set(names) <= set(tk.__all__)
    # the same kind of object under each name (class, function, value)
    for n in names:
        assert callable(getattr(tk, n)) == callable(getattr(jk, n)), n
        assert isinstance(getattr(tk, n), type) == isinstance(getattr(jk, n), type), n
    assert tk.n_words is tk.kmer.n_words and tk.n_words is not convert.n_words


def test_spaced_kmers_ambiguity_outside_sampled_windows():
    """A known difference of the reference itself, kept by the port: with
    J < K, ``SpacedDNAMers`` reads every base and raises on an ambiguous
    code after the last sampled window, while ``spaced_kmers`` (both
    packages') reads only the sampled windows and returns them.  On
    certain bases the three agree."""
    rng = np.random.default_rng(31)
    clean = seq(rng, "ACGTacgt", 31 + 7 * 10 + 3)
    want = [k.value for k in tk.SpacedDNAMers(31, 7, clean)]
    assert tpipe.spaced_kmers(clean, K=31, J=7, device="cpu").tolist() == want
    assert jpipe.spaced_kmers(clean, K=31, J=7).tolist() == want
    probe = clean + "R"
    got = tpipe.spaced_kmers(probe, K=31, J=7, device="cpu")
    assert got.tolist() == jpipe.spaced_kmers(probe, K=31, J=7).tolist() == want
    same(lambda p: list(p.SpacedDNAMers(31, 7, probe)))
    with pytest.raises(tk.EncodeError):
        list(tk.SpacedDNAMers(31, 7, probe))
