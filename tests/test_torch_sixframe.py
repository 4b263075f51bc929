"""The six-frame slice as a whole: ``kmers_tpu_torch`` six-frame amino-acid
counting on the CPU (kernels K4 and K5 as their plain versions) against
``kmers_tpu.parallel.sixframe.sharded_sixframe_aa_count`` over
``data_mesh(1)`` (its jnp route) and a string-level translation, with the
same metrics, checked mode, config errors and CLI output."""

import collections
import json

import numpy as np
import pytest

from kmers_tpu import genetic_codes as jgc
from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.parallel import sixframe as jsf
from kmers_tpu.parallel.mesh import data_mesh
from kmers_tpu.utils import Metrics as JaxMetrics
from kmers_tpu.utils import checked as jax_checked
from kmers_tpu_torch import genetic_codes as tgc
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.pipelines import sixframe as tsf
from kmers_tpu_torch.utils import Metrics, checked

# upper- and lower-case bases, U, N, IUPAC codes and bytes of no alphabet
POOL = np.frombuffer(b"ACGTacgtUNRY-X!", np.uint8)


def _seq(L, seed, junk=0.02):
    rng = np.random.default_rng(seed)
    p = np.full(len(POOL), junk / 6)
    p[:9] = (1 - junk) / 9
    s = POOL[rng.choice(len(POOL), L, p=p)]
    if L >= 2000:
        s[L // 2 : L // 2 + 300] = s[100:400]  # a repeat, so counts exceed 1
    return s


def _port(data, K, chunk_size=1 << 20, number=1, metrics=None):
    cfg = tsf.SixFrameCountConfig(K=K, chunk_size=chunk_size, code=tgc.ncbi_trans_table[number])
    return tsf.sixframe_aa_count(data, cfg, metrics=metrics, device="cpu")


def _jax(data, K, chunk_size=1 << 20, number=1, metrics=None):
    cfg = jsf.SixFrameCountConfig(K=K, chunk_size=chunk_size, code=jgc.ncbi_trans_table[number])
    return jsf.sharded_sixframe_aa_count(bytes(np.asarray(data, np.uint8)), cfg, data_mesh(1), metrics)


def _equal(got, want):
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype == np.int64
    # K > 7 values are object arrays of Python ints: compare as ints
    assert got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])
    assert got[0].tolist() == sorted(got[0].tolist())


@pytest.mark.parametrize("K,L", [(1, 1000), (4, 3000), (5, 4000), (7, 8000), (8, 4000),
                                 (11, 2000), (15, 6000), (32, 4000)])
def test_matches_jax_in_one_chunk(K, L):
    data = _seq(L, K, junk=0.02 if K <= 8 else 0.004)
    got = _port(data, K)
    _equal(got, _jax(data, K))
    assert got[1].max() >= 2


@pytest.mark.parametrize("K,chunk_size", [(4, 1024), (7, 1400), (15, 1500)])
def test_matches_jax_in_several_chunks(K, chunk_size):
    # chunks of 1024 and 1400 bytes end inside a codon, and every chunk
    # ends inside a window
    data = _seq(4000, 100 + K, junk=0.01)
    got = _port(data, K, chunk_size)
    assert len(range(0, 4000 - 3 * K + 1, chunk_size - (3 * K - 1))) >= 3
    _equal(got, _jax(data, K, chunk_size=1400))
    _equal(got, _port(data, K))


@pytest.mark.parametrize("K,number", [(7, 2), (11, 5)])
def test_matches_jax_under_another_genetic_code(K, number):
    data = _seq(3000, 200 + K, junk=0.005)
    got = _port(data, K, number=number)
    _equal(got, _jax(data, K, number=number))
    assert got[0].tolist() != _port(data, K)[0].tolist()


@pytest.mark.parametrize("K,L", [(1, 0), (1, 2), (7, 20), (15, 44), (32, 95)])
def test_shorter_than_3k_gives_empty_arrays(K, L):
    data = _seq(L, 1)
    got, want = _port(data, K), _jax(data, K)
    _equal(got, want)
    assert got[0].dtype == np.uint64 and got[0].size == 0


@pytest.mark.parametrize("K", [5, 9])
def test_no_valid_window(K):
    data = np.frombuffer(b"ACGTNACGTN" * 10, np.uint8)
    got = _port(data, K)
    _equal(got, _jax(data, K))
    assert got[0].size == 0


#: NCBI transl_table 1, amino acids of the codons TTT, TTC, TTA, ... (T, C, A, G)
NCBI_STANDARD = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def _string_counter(text, K, ncbi):
    """{register: count} from Python strings: each strand's three frames
    translated with the NCBI string, windows of K amino acids whose codons
    are all certain."""
    aa_code = {}
    for i, ch in enumerate(ncbi):
        codon = "TCAG"[i >> 4] + "TCAG"[(i >> 2) & 3] + "TCAG"[i & 3]
        aa_code[codon] = tgc.AA_CHARS.index(ch)
    text = text.upper().replace("U", "T")
    rc = text.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    out = collections.Counter()
    for strand in (text, rc):
        for f in range(3):
            aas = [aa_code.get(strand[i : i + 3]) for i in range(f, len(strand) - 2, 3)]
            for i in range(len(aas) - K + 1):
                w = aas[i : i + K]
                if None not in w:
                    out[sum(a << (8 * (K - 1 - j)) for j, a in enumerate(w))] += 1
    return dict(out)


@pytest.mark.parametrize("K", [3, 9])
def test_matches_string_translation(K):
    data = _seq(1500, 300 + K, junk=0.01)
    kmers, counts = _port(data, K, chunk_size=400)
    want = _string_counter(data.tobytes().decode(), K, NCBI_STANDARD)
    assert dict(zip(kmers.tolist(), counts.tolist())) == want


@pytest.mark.parametrize("K,chunk_size", [(6, 1 << 20), (6, 700), (12, 900)])
def test_metrics_match_jax(K, chunk_size):
    data = _seq(2500, 400 + K)
    m, jm = Metrics(), JaxMetrics()
    _port(data, K, chunk_size, metrics=m)
    _jax(data, K, metrics=jm)
    assert len(m.batches) == len(jm.batches) == 1
    got, want = m.batches[0], jm.batches[0]
    for field in ("bases_in", "windows_out", "windows_skipped", "distinct_kmers"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.windows_out > 0 and got.windows_skipped > 0


@pytest.mark.parametrize("K,chunk_size", [(7, 1 << 20), (7, 800), (10, 800)])
def test_checked_mode_matches_jax(K, chunk_size):
    data = _seq(2400, 500 + K, junk=0.01)
    with checked():
        got = _port(data, K, chunk_size)
    with jax_checked():
        want = _jax(data, K)
    _equal(got, want)


@pytest.mark.parametrize("K", [6, 12])
def test_checked_mode_catches_a_lost_count(monkeypatch, K):
    name = "sort_count" if K <= 7 else "sort_count_mw"
    real = getattr(tsf, name)

    def lossy(*args, **kwargs):
        uniq, counts, n_unique = real(*args, **kwargs)
        counts = counts.clone()
        counts[int(counts.argmax())] -= 1
        return uniq, counts, n_unique

    monkeypatch.setattr(tsf, name, lossy)
    data = _seq(1200, 9, junk=0.01)
    _port(data, K)  # unchecked: the loss goes unseen
    with checked(), pytest.raises(RuntimeError, match="conservation"):
        _port(data, K)


@pytest.mark.parametrize("kwargs", [{"K": 0}, {"K": 33}, {"K": 7, "chunk_size": 41}])
def test_config_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jsf.SixFrameCountConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        tsf.SixFrameCountConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(tsf.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsf.sixframe_aa_count(b"ACGTACGTACGT", device="cuda")


@pytest.mark.parametrize("k", [7, 9])
def test_cli_matches_jax_cli(tmp_path, capsys, k):
    recs = [_seq(900, 40 + i, junk=0.01).tobytes().decode() for i in range(3)]
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n{r[:450]}\n{r[450:]}\n" for i, r in enumerate(recs)))
    port_main(["sixframe", str(fa), "-k", str(k), "--device", "cpu"])
    got = capsys.readouterr().out
    jax_main(["sixframe", str(fa), "-k", str(k)])
    want = capsys.readouterr().out
    assert got == want and json.loads(got)["total"] > 0
