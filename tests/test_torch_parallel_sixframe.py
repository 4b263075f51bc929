"""Sharded six-frame counting of the port, ``kmers_tpu_torch.parallel``'s
``sharded_sixframe_aa_count``, on the CPU: local meshes of 1-8 ranks
against ``kmers_tpu.parallel.sixframe.sharded_sixframe_aa_count`` over the
forced host devices of ``tests/conftest.py``, bit for bit in ``kmers``
(dtype included) and ``counts``, with the same overflow decisions, metrics
and checked-mode errors, and each rank's merged table equal to the
reference device's; then the port's world sizes against the port on one
device, and the CLI.  Each JAX geometry compiles (2-5 s), so the reference
is called on few of them and its results are cached for the module."""

import functools
import importlib
import json
import math

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from kmers_tpu import genetic_codes as jgc
from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.parallel import data_mesh as jax_data_mesh
from kmers_tpu.parallel import sixframe as jsf
from kmers_tpu.utils import Metrics as JaxMetrics
from kmers_tpu.utils import checked as jax_checked
from kmers_tpu_torch import genetic_codes as tgc
from kmers_tpu_torch import parallel as tpar
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.convert import table_from_jax, words_from_jax
from kmers_tpu_torch.ops.hashing import fx_hash_u64
from kmers_tpu_torch.ops.multiword import fx_hash_mw
from kmers_tpu_torch.pipelines import sixframe as tsf
from kmers_tpu_torch.utils import Metrics, checked

jpipe = importlib.import_module("kmers_tpu.parallel.pipeline")
tsix = importlib.import_module("kmers_tpu_torch.parallel.sixframe")
tpipe = importlib.import_module("kmers_tpu_torch.parallel.pipeline")

# upper- and lower-case bases, U, N, IUPAC codes and bytes of no alphabet
POOL = np.frombuffer(b"ACGTacgtUNRY-X!", np.uint8)
BIG = 1 << 20


def _seq(L, seed, junk=0.02):
    rng = np.random.default_rng(seed)
    p = np.full(len(POOL), junk / 6)
    p[:9] = (1 - junk) / 9
    s = POOL[rng.choice(len(POOL), L, p=p)]
    if L >= 2000:
        s[L // 2 : L // 2 + 300] = s[100:400]  # a repeat, so counts exceed 1
    return s


# the parity input: a slab of 2700 bytes a rank at n = 3 (3 chunks of 900),
# 1014 at n = 8 (2 chunks of 900), 8100 at n = 1 (4 chunks of 2031)
SEQ = _seq(8100, 12, junk=0.01)


def _port_mesh(n):
    return tpar.data_mesh(n, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax(data: bytes, n, K, chunk, bucket_factor=2.0, number=1):
    """The reference's result, or ``RuntimeError`` where it raised."""
    cfg = jsf.SixFrameCountConfig(K=K, chunk_size=chunk, bucket_factor=bucket_factor,
                                  code=jgc.ncbi_trans_table[number])
    try:
        return jsf.sharded_sixframe_aa_count(data, cfg, jax_data_mesh(n))
    except RuntimeError as err:
        assert "overflow" in str(err)
        return RuntimeError


def _port(data, n, K, chunk, bucket_factor=2.0, number=1, metrics=None):
    cfg = tpar.SixFrameCountConfig(K=K, chunk_size=chunk, bucket_factor=bucket_factor,
                                   code=tgc.ncbi_trans_table[number])
    try:
        return tpar.sharded_sixframe_aa_count(data, cfg, _port_mesh(n), metrics=metrics)
    except RuntimeError as err:
        assert str(err) == "hash-prefix bucket overflow; increase bucket_factor"
        return RuntimeError


def _equal(got, want):
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype == np.int64
    # K > 7 values are object arrays of Python ints: compare as ints
    assert got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])
    assert got[0].tolist() == sorted(got[0].tolist())


def _same_outcome(got, want):
    if isinstance(want, type):
        assert got is want
    else:
        _equal(got, want)


@pytest.mark.parametrize("n,K,chunk", [
    # one chunk a rank
    (1, 1, BIG), (3, 5, BIG), (8, 7, BIG), (3, 8, BIG), (1, 15, BIG), (3, 32, BIG),
    # several chunks a rank
    (3, 7, 900), (8, 5, 900), (8, 15, 900), (3, 12, 900), (8, 32, 900),
    # the reference's own shaving case: chunk_size 2035 rounds its body to
    # 2034, whose 2(B + 16) windows overhang 2^12 by 4, so it shaves the
    # body to 2031 (tests/test_parallel.py); the port's chunking ignores it
    (1, 5, 2035),
])
def test_matches_reference(n, K, chunk):
    want = _jax(SEQ.tobytes(), n, K, chunk)
    got = _port(SEQ, n, K, chunk)
    _equal(got, want)
    assert got[1].sum() > 0 and got[1].max() >= 2


@pytest.mark.parametrize("K,chunk,number", [(7, BIG, 2), (11, 900, 5)])
def test_matches_reference_under_another_genetic_code(K, chunk, number):
    got = _port(SEQ, 3, K, chunk, number=number)
    _equal(got, _jax(SEQ.tobytes(), 3, K, chunk, number=number))
    assert got[0].tolist() != _port(SEQ, 3, K, chunk)[0].tolist()


@pytest.mark.parametrize("K,L", [(7, 20), (7, 21), (12, 35), (12, 36), (1, 2), (1, 3)])
def test_shorter_than_3k_and_exactly_3k(K, L):
    data = np.frombuffer(b"ACGTTGCAACGTTGCAAGGCCTTAACGTTGCAAGGCCTTA"[:L], np.uint8)
    got = _port(data, 3, K, BIG)
    _equal(got, _jax(data.tobytes(), 3, K, BIG))
    if L < 3 * K:
        assert got[0].dtype == np.uint64 and got[0].size == 0
    else:
        # one window a strand, each on one rank
        assert got[1].sum() == 2


def _reference_slabs(arr, n, K):
    """``kmers_tpu/parallel/sixframe.py``'s slab construction, line for line."""
    H = 3 * K
    L = arr.shape[0]
    shard = -(-L // n)
    shard += (-shard) % 3
    padded = np.zeros(n * shard + H, dtype=np.uint8)
    padded[:L] = arr
    shards = np.zeros((n, shard + 2 * H), dtype=np.uint8)
    for d in range(n):
        lo_i = d * shard - H
        src_lo = max(lo_i, 0)
        dst_lo = src_lo - lo_i
        seg = padded[src_lo : d * shard + shard + H]
        shards[d, dst_lo : dst_lo + seg.shape[0]] = seg
    return shards, shard


@pytest.mark.parametrize("n,K,L", [(1, 7, 100), (3, 7, 8100), (8, 12, 1001), (5, 32, 97)])
def test_slabs_match_reference(n, K, L):
    arr = _seq(L, L)
    got, want = tsix._sixframe_slabs(arr, n, K), _reference_slabs(arr, n, K)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def _capture_exchange(monkeypatch):
    calls = []
    real = tsix._exchange_tables

    def spy(tables, mesh, cap, K):
        merged, overflow = real(tables, mesh, cap, K)
        calls.append({"tables": tables, "cap": cap, "merged": merged, "overflow": overflow})
        return merged, overflow

    monkeypatch.setattr(tsix, "_exchange_tables", spy)
    return calls


def _route_keys(keys, n, K):
    return tpipe.destination(fx_hash_u64(keys) if K <= 7 else fx_hash_mw(keys, K, bps=8), n)


def _words_per_rank(limbs, cnt, K, n):
    """A sharded JAX word table (limbs, counts) as each rank's real rows."""
    cnt = np.asarray(cnt)
    words = words_from_jax([np.asarray(x) for x in limbs], K, bps=8, valid=cnt > 0, n_ranks=n)
    return [(w[:, c > 0], torch.from_numpy(c[c > 0].astype(np.int64))) for w, c in zip(words, np.split(cnt, n))]


@pytest.mark.parametrize("K", [7, 12])
def test_each_rank_holds_the_reference_devices_table(monkeypatch, K):
    # the parity geometry at n = 3 (the reference's steps are cached): rank
    # r's folded local table, which decides its bucket overflow, and its
    # merged table are device r's, row for row
    n, chunk = 3, 900
    calls = _capture_exchange(monkeypatch)
    _equal(_port(SEQ, n, K, chunk), _jax(SEQ.tobytes(), n, K, chunk))
    (call,) = calls

    jmesh = jax_data_mesh(n)
    sharding = NamedSharding(jmesh, P(jmesh.axis_names[0], None))
    cfg = jsf.SixFrameCountConfig(K=K, chunk_size=chunk)
    shards, shard = _reference_slabs(SEQ, n, K)
    tbl_bytes = bytes(np.asarray(cfg.code.tbl).tobytes())
    # the reference's local tables are the inputs of its exchange step
    local = []
    module, name = (jpipe, "_exchange_step") if K <= 7 else (jsf, "_exchange_step_mw")
    real_step = getattr(module, name)

    def step(*args):
        exchange = real_step(*args)

        def spy(*tbl):
            local.append([np.asarray(x) for x in tbl])
            return exchange(*tbl)

        return spy

    monkeypatch.setattr(module, name, step)
    if K <= 7:
        uh, ul, cnt, overflow, _ = jsf._streamed_sixframe_count(shards, shard, jmesh, cfg, sharding, tbl_bytes)
        want = table_from_jax(np.asarray(uh), np.asarray(ul), np.asarray(cnt), n_ranks=n)
        want_local = table_from_jax(*local[0], n_ranks=n)
    else:
        limbs, cnt, overflow, _ = jsf._streamed_sixframe_count_mw(shards, shard, jmesh, cfg, sharding, tbl_bytes)
        want = _words_per_rank(limbs, cnt, K, n)
        want_local = _words_per_rank(local[0][:-1], local[0][-1], K, n)
    assert int(np.asarray(overflow)[0]) == 0 and call["overflow"] == 0
    for (keys, counts), (wkeys, wcounts) in zip(call["tables"], want_local):
        real = counts > 0
        assert torch.equal(keys[..., real], wkeys) and torch.equal(counts[real], wcounts)
    for rank, ((keys, counts, n_unique), (wkeys, wcounts)) in enumerate(zip(call["merged"], want)):
        real = counts > 0
        assert int(n_unique) == int(real.sum()) == wcounts.shape[0] > 0
        assert torch.equal(keys[..., real], wkeys) and torch.equal(counts[real], wcounts)
        assert bool((_route_keys(keys[..., real], n, K) == rank).all())


def _bucket_load(tables, n, K):
    """The largest bucket load (real rows bound for one rank) over the
    ranks' folded tables, and the width the capacity is computed from."""
    loads, widths = [], []
    for keys, counts in tables:
        real = counts > 0
        loads.append(int(torch.bincount(_route_keys(keys[..., real], n, K), minlength=n).max()))
        widths.append(int(real.sum()))
    return max(loads), tpipe._next_pow2(max(widths))


@pytest.mark.parametrize("K", [7, 12])
def test_bucket_factor_sweep_raises_where_reference_raises(monkeypatch, K):
    n, chunk = 3, 900
    calls = _capture_exchange(monkeypatch)
    _port(SEQ, n, K, chunk)
    load, width = _bucket_load(calls[0]["tables"], n, K)
    assert calls[0]["cap"] == math.ceil(width * 2.0 / n)
    # capacities load - 1 (overflow by one row) and load (fits exactly),
    # then coarse factors on both sides
    factors = [(load - 1.5) * n / width, (load - 0.5) * n / width, 0.2, 2.0]
    outcomes = []
    for bf in factors:
        want = _jax(SEQ.tobytes(), n, K, chunk, bucket_factor=bf)
        _same_outcome(_port(SEQ, n, K, chunk, bucket_factor=bf), want)
        outcomes.append(want is RuntimeError)
    assert outcomes == [True, False, True, False]


@pytest.mark.parametrize("K", [7, 12])
def test_checked_mode_and_metrics_match_reference(K):
    n, chunk = 3, 900
    m, jm = Metrics(), JaxMetrics()
    with checked():
        got = _port(SEQ, n, K, chunk, metrics=m)
    with jax_checked():
        want = jsf.sharded_sixframe_aa_count(
            SEQ.tobytes(), jsf.SixFrameCountConfig(K=K, chunk_size=chunk), jax_data_mesh(n), metrics=jm
        )
    _equal(got, want)
    (b,), (jb,) = m.batches, jm.batches
    for field in ("bases_in", "windows_out", "windows_skipped", "distinct_kmers"):
        assert getattr(b, field) == getattr(jb, field), field
    assert b.bases_in == SEQ.size and b.windows_out == int(got[1].sum()) and b.windows_skipped > 0


@pytest.mark.parametrize("where", ["local", "exchange"])
@pytest.mark.parametrize("K", [6, 12])
def test_checked_mode_catches_a_lost_count(monkeypatch, K, where):
    if where == "local":
        module, name = tsf, "sort_count" if K <= 7 else "sort_count_mw"
    else:
        module, name = (tpipe, "_merge_one_word") if K <= 7 else (tsix, "_merge_words")
    real = getattr(module, name)

    def lossy(*args, **kwargs):
        keys, counts, n_unique = real(*args, **kwargs)
        counts = counts.clone()
        counts[int(counts.argmax())] -= 1
        return keys, counts, n_unique

    monkeypatch.setattr(module, name, lossy)
    data = _seq(1500, 9, junk=0.01)
    cfg = tpar.SixFrameCountConfig(K=K)
    tpar.sharded_sixframe_aa_count(data, cfg, _port_mesh(2))  # unchecked: unseen
    phrase = "local count" if where == "local" else "exchange"
    with checked(), pytest.raises(RuntimeError, match=f"conservation violated .* {phrase}"):
        tpar.sharded_sixframe_aa_count(data, cfg, _port_mesh(2))


@pytest.mark.parametrize("kwargs", [{"K": 0}, {"K": 33}, {"K": 7, "chunk_size": 41}])
def test_config_errors_match_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jsf.SixFrameCountConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        tpar.SixFrameCountConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_cuda_mesh_without_a_card_raises(monkeypatch, tmp_path):
    # no fallback: neither the default mesh nor the CLI's --device cuda
    # carries on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpar.sharded_sixframe_aa_count(b"ACGTACGTACGTACGTACGTACGT")
    fa = tmp_path / "r.fa"
    fa.write_text(">r\nACGTACGTACGTACGTACGTACGT\n")
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["sixframe", str(fa), "--device", "cuda"])


# ---------------------------------------------------------------- the port alone


@pytest.mark.parametrize("n", range(1, 9))
def test_world_sizes_equal_one_device(n):
    data = _seq(3000, 30 + n)
    for K, chunk in ((7, BIG), (5, 211), (12, BIG), (9, 300)):
        one = tsf.sixframe_aa_count(data, tsf.SixFrameCountConfig(K=K), device="cpu")
        _equal(_port(data, n, K, chunk), one)


@pytest.mark.parametrize("K", [7, 12])
def test_a_rank_with_no_window(K):
    # rank 1's slab is all N, so its folded table is empty (several chunks)
    data = np.concatenate([_seq(1000, 60), np.full(1000, ord("N"), np.uint8), _seq(2000, 61)])
    one = tsf.sixframe_aa_count(data, tsf.SixFrameCountConfig(K=K), device="cpu")
    _equal(_port(data, 4, K, 6 * K), one)


def test_explicit_mesh_with_repeated_devices():
    data = _seq(2000, 40)
    got = tpar.sharded_sixframe_aa_count(data, tpar.SixFrameCountConfig(K=7), tpar.Mesh(["cpu"] * 4))
    _equal(got, tsf.sixframe_aa_count(data, tsf.SixFrameCountConfig(K=7), device="cpu"))


@pytest.mark.parametrize("k", [7, 12])
def test_cli_matches_jax_cli(tmp_path, capsys, k):
    recs = [_seq(1200, 50 + i, junk=0.01).tobytes().decode() for i in range(3)]
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n{r[:600]}\n{r[600:]}\n" for i, r in enumerate(recs)))
    port_main(["sixframe", str(fa), "-k", str(k), "--device", "cpu"])
    got = capsys.readouterr().out
    jax_main(["sixframe", str(fa), "-k", str(k)])
    want = capsys.readouterr().out
    assert got == want and json.loads(got)["total"] > 0
