"""The parallel plane of the port, ``kmers_tpu_torch.parallel``, on the CPU:
local meshes of 1-8 ranks (``data_mesh(n, device="cpu")``) against the JAX
package's ``kmers_tpu.parallel`` over ``data_mesh(n)`` (the forced host
devices of ``tests/conftest.py``), bit for bit, with the same errors and
the same bucket-overflow decisions; then the port's world sizes against
the port on one device.  Each JAX geometry compiles, so the reference is
called on few of them and its results are cached for the module."""

import functools
import importlib

import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
import numpy as np
import pytest
import torch

from kmers_tpu import parallel as jpar
from kmers_tpu.alphabets import EncodeError as JaxEncodeError
from kmers_tpu.ops.hashing import fx_hash_u64 as jax_fx_hash_u64
from kmers_tpu.ops.multiword import fx_hash_mw as jax_fx_hash_mw
from kmers_tpu.ops.multiword import n_limbs as jax_n_limbs
from kmers_tpu.utils import Metrics as JaxMetrics
from kmers_tpu.utils import checked as jax_checked
from kmers_tpu_torch import parallel as tpar
from kmers_tpu_torch.convert import (
    SENTINEL,
    hashes_from_jax,
    n_words,
    table_from_jax,
    words_from_jax,
    words_to_jax,
)
from kmers_tpu_torch.ops.hashing import fx_hash_u64
from kmers_tpu_torch.ops.multiword import fx_hash_mw, n_limbs
from kmers_tpu_torch.symbols import EncodeError
from kmers_tpu_torch.utils import Metrics, checked

jcc = importlib.import_module("kmers_tpu.pipelines.canonical_count")
tcc = importlib.import_module("kmers_tpu_torch.pipelines.canonical_count")
tpipe = importlib.import_module("kmers_tpu_torch.parallel.pipeline")
textract = importlib.import_module("kmers_tpu_torch.pipelines.extract")

# 4 slab chunks a rank for every world size below (see _streamed_chunk)
L_PARITY = 1920


def _dna(L, seed, n_share=0.002):
    rng = np.random.default_rng(seed)
    p = np.array([1.0, 1.0, 1.0, 1.0, 4 * n_share / (1 - n_share)])
    return np.frombuffer(b"ACGTN", np.uint8)[rng.choice(5, size=L, p=p / p.sum())]


SEQ = _dna(L_PARITY, 11)


def _streamed_chunk(L, n_dev, K):
    """A chunk size giving each rank exactly 4 full chunks: the chunk stride
    is a quarter of the slab's body.  Every world size's tables then have
    the same power-of-two widths at every K, so the reference compiles its
    merges once a mesh."""
    shard = -(-L // n_dev)
    assert shard % 4 == 0
    return shard // 4 + K - 1


def _port_mesh(n):
    return tpar.data_mesh(n, device="cpu")


def _equal(got, want):
    assert got[0].dtype == want[0].dtype == np.uint64
    assert got[1].dtype == want[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _equal_mw(got, want):
    assert got[0].dtype == want[0].dtype == object
    assert [int(x) for x in got[0]] == [int(x) for x in want[0]]
    assert got[1].dtype == np.int64 and np.array_equal(got[1], want[1])


@functools.lru_cache(maxsize=None)
def _jax_count(data: bytes, n, K, chunk, bucket_factor=2.0):
    """The reference's result, or the class of the error it raised."""
    cfg = jpar.ShardedCountConfig(K=K, chunk_size=chunk, bucket_factor=bucket_factor)
    try:
        return jpar.sharded_canonical_count(data, cfg, jpar.data_mesh(n))
    except (RuntimeError, JaxEncodeError) as err:
        return type(err)


def _port_count(data, n, K, chunk, bucket_factor=2.0):
    cfg = tpar.ShardedCountConfig(K=K, chunk_size=chunk, bucket_factor=bucket_factor)
    try:
        return tpar.sharded_canonical_count(data, cfg, _port_mesh(n))
    except EncodeError:
        return JaxEncodeError
    except RuntimeError as err:
        assert str(err) == "hash-prefix bucket overflow; increase bucket_factor"
        return RuntimeError


def _same_outcome(got, want):
    if isinstance(want, type):
        assert got is want
    else:
        _equal(got, want)


# ---------------------------------------------------------------- K <= 31


@pytest.mark.parametrize("route", ["single", "streamed"])
@pytest.mark.parametrize("K", [9, 15, 31])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_count_matches_reference(n, K, route):
    chunk = 1 << 20 if route == "single" else _streamed_chunk(L_PARITY, n, K)
    want = _jax_count(SEQ.tobytes(), n, K, chunk)
    assert not isinstance(want, type), want
    _equal(_port_count(SEQ, n, K, chunk), want)


@pytest.mark.parametrize("chunk", [1 << 20, 997])
def test_boundary_motif_matches_reference(chunk):
    # every slab and chunk boundary cuts the repeated motif; the reference
    # runs the streamed geometry, the single one is held to one device
    s = b"ACGTACGTA" * 2000
    got = _port_count(s, 8, 9, chunk)
    if chunk == 997:
        _equal(got, _jax_count(s, 8, 9, chunk))
    else:
        _equal(got, tcc.canonical_count_bytes(s, tcc.CountConfig(K=9), device="cpu"))
    assert got[1].sum() == len(s) - 9 + 1


def test_short_input_and_config_errors():
    for n in (1, 8):
        for count in (_port_count, _jax_count):
            got = count(b"ACG", n, 31, 1 << 20)
            assert got[0].dtype == np.uint64 and got[0].size == 0 and got[1].size == 0
    for cfg in (tpar.ShardedCountConfig, jpar.ShardedCountConfig):
        with pytest.raises(ValueError):
            cfg(K=32)
        with pytest.raises(ValueError):
            cfg(K=0)
        with pytest.raises(ValueError):
            cfg(K=15, chunk_size=14)


@pytest.mark.parametrize("n", [1, 4])
def test_invalid_bytes_raise_as_reference(n):
    s = b"ACGT!" + b"ACGT" * 100
    assert _jax_count(s, n, 5, 1 << 20) is JaxEncodeError
    assert _port_count(s, n, 5, 1 << 20) is JaxEncodeError
    # an invalid byte in the last rank's halo-free tail, on the streamed route
    s = b"ACGT" * 100 + b"!"
    assert _port_count(s, n, 5, 37) is JaxEncodeError
    # ambiguous bases are skipped, never an error
    got = _port_count(b"ACGTNRYACGT" * 50, n, 5, 1 << 20)
    assert got[1].sum() > 0


def test_poly_a_fits_a_small_bucket_factor():
    s = b"A" * 4000
    got = _port_count(s, 8, 31, 1 << 20, bucket_factor=0.3)
    _equal(got, _jax_count(s, 8, 31, 1 << 20, bucket_factor=0.3))
    assert got[0].tolist() == [0] and got[1].tolist() == [4000 - 31 + 1]


def test_random_dna_overflows_as_reference():
    s = _dna(20000, 5, n_share=0.0).tobytes()
    assert _jax_count(s, 8, 31, 1 << 20, bucket_factor=0.01) is RuntimeError
    assert _port_count(s, 8, 31, 1 << 20, bucket_factor=0.01) is RuntimeError


def _bucket_loads(data, n, K, chunk):
    """The port's local tables' largest bucket load (real rows bound for
    one rank) and the width the capacity is computed from (``shard`` on
    the single route, the folded table width on the streamed one)."""
    rows, shard = tpipe._shard_with_halo(np.frombuffer(data, np.uint8), n, K, ord("N"))
    streamed = -(-shard // chunk) > 1
    loads, widths = [], []
    for r in range(n):
        slab = torch.from_numpy(rows[r].copy())
        if streamed:
            (keys, counts), _ = tpipe.count_stream(
                slab, K, chunk, lambda c: tcc._count_chunk(c, K, False), tcc.merge_compact_tables
            )
        else:
            (keys, counts), _ = tcc._count_chunk(slab, K, False)
        dest = tpipe.destination(fx_hash_u64(keys[counts > 0]), n)
        loads.append(int(torch.bincount(dest, minlength=n).max()))
        widths.append(int((counts > 0).sum()))
    width = tpipe._next_pow2(max(widths)) if streamed else shard
    return max(loads), width


@pytest.mark.parametrize("route", ["single", "streamed"])
def test_bucket_factor_sweep_raises_where_reference_raises(route):
    # the parity input and geometry, so that the reference reuses its steps
    n, K = 3, 15
    data = SEQ.tobytes()
    chunk = 1 << 20 if route == "single" else _streamed_chunk(L_PARITY, n, K)
    load, width = _bucket_loads(data, n, K, chunk)
    # capacities load - 1 (overflow by one row) and load (fits exactly),
    # then coarse factors on both sides
    factors = [(load - 1.5) * n / width, (load - 0.5) * n / width, 0.2, 2.0]
    outcomes = []
    for bf in factors:
        want = _jax_count(data, n, K, chunk, bucket_factor=bf)
        _same_outcome(_port_count(data, n, K, chunk, bucket_factor=bf), want)
        outcomes.append(want is RuntimeError)
    assert outcomes[:2] == [True, False] and outcomes[2] and not outcomes[-1]


@pytest.mark.parametrize("route", ["single", "streamed"])
def test_checked_mode_and_metrics_match_reference(route):
    # tests/test_extras.py's sharded metrics test, on both routes and in
    # checked mode, on the parity input and geometry
    chunk = 1 << 20 if route == "single" else _streamed_chunk(L_PARITY, 3, 15)
    m, jm = Metrics(), JaxMetrics()
    with checked():
        got = tpar.sharded_canonical_count(
            SEQ, tpar.ShardedCountConfig(K=15, chunk_size=chunk), _port_mesh(3), metrics=m
        )
    with jax_checked():
        want = jpar.sharded_canonical_count(
            SEQ.tobytes(), jpar.ShardedCountConfig(K=15, chunk_size=chunk), jpar.data_mesh(3),
            metrics=jm,
        )
    _equal(got, want)
    (b,), (jb,) = m.batches, jm.batches
    for field in ("bases_in", "windows_out", "windows_skipped", "distinct_kmers"):
        assert getattr(b, field) == getattr(jb, field), field
    assert b.bases_in == L_PARITY and b.windows_out == int(got[1].sum()) and b.windows_skipped > 0


@pytest.mark.parametrize("where", ["local", "exchange"])
def test_checked_mode_catches_a_lost_count(monkeypatch, where):
    if where == "local":
        real, name = tcc.sort_count, "sort_count"
        module = tcc
    else:
        real, name = tpipe._merge_one_word, "_merge_one_word"
        module = tpipe

    def lossy(*args, **kwargs):
        keys, counts, n_unique = real(*args, **kwargs)
        counts = counts.clone()
        counts[int(counts.argmax())] -= 1
        return keys, counts, n_unique

    monkeypatch.setattr(module, name, lossy)
    seq = _dna(900, 8)
    cfg = tpar.ShardedCountConfig(K=9)
    tpar.sharded_canonical_count(seq, cfg, _port_mesh(2))  # unchecked: unseen
    with checked(), pytest.raises(RuntimeError, match="conservation"):
        tpar.sharded_canonical_count(seq, cfg, _port_mesh(2))


# ---------------------------------------------------------------- routing


def test_destination_matches_reference_formula():
    rng = np.random.default_rng(4)
    regs = rng.integers(0, 1 << 62, 5000, dtype=np.int64)
    hh, _ = jax_fx_hash_u64(
        jnp.asarray((regs >> 32).astype(np.uint32)), jnp.asarray((regs & 0xFFFFFFFF).astype(np.uint32))
    )
    hh = np.asarray(hh)
    keys = fx_hash_u64(torch.from_numpy(regs))
    for n in range(1, 9):
        shift = 32 - max(n - 1, 1).bit_length()
        want = (hh >> np.uint32(shift)) % np.uint32(n)
        got = tpipe.destination(keys, n).numpy()
        assert np.array_equal(got, want.astype(np.int64)), n
        assert set(got.tolist()) == set(range(n))


def test_each_rank_holds_the_keys_it_owns():
    seq = _dna(6000, 9)
    mesh = _port_mesh(5)
    rows, shard = tpipe._shard_with_halo(seq, 5, 13, ord("N"))
    slabs = mesh.put(rows)
    merged, _, overflow = tpipe.sharded_count_step(slabs, mesh, 13, cap=shard)
    assert overflow == 0
    seen = []
    for rank, (keys, counts, n_unique) in zip(mesh.ranks, merged):
        real = keys[counts > 0]
        assert int(n_unique) == real.shape[0]
        assert bool((tpipe.destination(fx_hash_u64(real), 5) == rank).all())
        assert bool((real[1:] > real[:-1]).all())
        seen += real.tolist()
    want = tcc.canonical_count_bytes(seq, tcc.CountConfig(K=13), device="cpu")
    assert sorted(seen) == want[0].astype(np.int64).tolist()


@pytest.mark.parametrize("kind", ["one word", "words"])
def test_each_rank_holds_the_reference_devices_table(kind):
    # the parity geometries at n = 3 (the reference's steps are cached):
    # rank r's merged table is device r's, row for row
    n = 3
    mesh, jmesh = _port_mesh(n), jpar.data_mesh(n)
    sharding = NamedSharding(jmesh, P(jmesh.axis_names[0], None))
    if kind == "one word":
        K, seq = 15, SEQ
        rows, shard = jpar.pipeline._shard_with_halo(seq, n, K, ord("N"))
        cap = int(np.ceil(shard * 2.0 / n))
        uh, ul, cnt, *_ = jpar.sharded_count_step(jmesh, K, shard, cap)(
            jpar.pipeline._put_sharded(rows, sharding)
        )
        want = table_from_jax(np.asarray(uh), np.asarray(ul), np.asarray(cnt), n_ranks=n)
        merged, _, overflow = tpipe.sharded_count_step(
            mesh.put(tpipe._shard_with_halo(seq, n, K, ord("N"))[0]), mesh, K, cap
        )
    else:
        K, seq = 47, _dna(5000, 42, n_share=0.02)
        rows, shard = jpar.pipeline._shard_with_halo(seq, n, K)
        cap = int(np.ceil(shard * 2.0 / n))
        limbs, cnt, *_ = jpar.multiword.sharded_count_step_mw(jmesh, K, shard, cap)(
            jpar.pipeline._put_sharded(rows, sharding)
        )
        cnt = np.asarray(cnt)
        words = words_from_jax([np.asarray(x) for x in limbs], K, valid=cnt > 0, n_ranks=n)
        want = [(w[:, c > 0], torch.from_numpy(c[c > 0].astype(np.int64)))
                for w, c in zip(words, np.split(cnt, n))]
        tables = [tcc._count_chunk_mw(slab, K)[0]
                  for slab in mesh.put(tpipe._shard_with_halo(seq, n, K, ord("N"))[0])]
        merged, overflow = tpar.exchange_and_merge_mw(tables, mesh, cap, K)
    assert overflow == 0
    for (keys, counts, n_unique), (wkeys, wcounts) in zip(merged, want):
        real = counts > 0
        assert int(n_unique) == int(real.sum()) == wcounts.shape[0] > 0
        assert torch.equal(keys[..., real], wkeys) and torch.equal(counts[real], wcounts)


def test_shard_with_halo_matches_reference():
    arr = _dna(1001, 2)
    for n, K in ((1, 5), (3, 31), (8, 9)):
        got = tpipe._shard_with_halo(arr, n, K, ord("N"))
        want = jpar.pipeline._shard_with_halo(arr, n, K, ord("N"))
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_route_buckets_hold_real_rows_first():
    keys = torch.tensor([5, 9, SENTINEL, 12, 7])
    counts = torch.tensor([2, 1, 0, 4, 3])
    buckets, overflow = tpipe._route(keys, counts, fx_hash_u64(keys), 2, cap=3)
    assert buckets.shape == (2, 3, 2) and int(overflow) == 0
    real = buckets[buckets[..., 1] > 0]
    assert sorted(real[:, 0].tolist()) == [5, 7, 9, 12] and int(real[:, 1].sum()) == 10
    # padding fills every slot after a bucket's real rows
    for b in buckets:
        n_real = int((b[:, 1] > 0).sum())
        assert bool((b[n_real:, 1] == 0).all()) and bool((b[n_real:, 0] == SENTINEL).all())
    _, overflow = tpipe._route(keys, counts, fx_hash_u64(keys), 2, cap=1)
    dest = tpipe.destination(fx_hash_u64(keys[counts > 0]), 2)
    assert int(overflow) == int((torch.bincount(dest, minlength=2) - 1).clamp(min=0).sum())


# ---------------------------------------------------------------- minimizers


@functools.lru_cache(maxsize=None)
def _jax_minimizers(data: bytes, n, skip):
    return jpar.sharded_minimizer_select(data, 15, 10, jpar.data_mesh(n), skip_ambiguous=skip)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_sharded_minimizers_match_reference(n, skip):
    seq = _dna(3000, 12, n_share=0.05 if skip else 0.0)
    got = tpar.sharded_minimizer_select(seq, 15, 10, _port_mesh(n), skip_ambiguous=skip)
    want = _jax_minimizers(seq.tobytes(), n, skip)
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[0].size > 100


def test_sharded_minimizer_errors_match_reference():
    ambiguous = b"ACGT" * 100 + b"N" + b"ACGT" * 100
    invalid = b"ACGT" * 100 + b"X" + b"ACGT" * 100
    with pytest.raises(EncodeError, match="ambiguous or invalid"):
        tpar.sharded_minimizer_select(ambiguous, mesh=_port_mesh(4))
    with pytest.raises(JaxEncodeError):
        jpar.sharded_minimizer_select(ambiguous, mesh=jpar.data_mesh(4))
    with pytest.raises(EncodeError, match="invalid base"):
        tpar.sharded_minimizer_select(invalid, mesh=_port_mesh(2), skip_ambiguous=True)
    with pytest.raises(JaxEncodeError):
        jpar.sharded_minimizer_select(invalid, mesh=jpar.data_mesh(2), skip_ambiguous=True)
    # skipping: the N is no error
    assert tpar.sharded_minimizer_select(ambiguous, mesh=_port_mesh(4), skip_ambiguous=True)[0].size
    for mesh in (_port_mesh(2),):
        v, p = tpar.sharded_minimizer_select(b"ACGT", K=15, W=10, mesh=mesh)
        assert v.size == 0 and v.dtype == np.uint64 and p.dtype == np.int64


# ---------------------------------------------------------------- K > 31


@pytest.mark.parametrize("n,K", [(1, 33), (3, 47), (8, 63)])
def test_sharded_multiword_matches_reference(n, K):
    seq = _dna(5000, 42, n_share=0.02)
    got = tpar.sharded_canonical_count_mw(seq, K=K, mesh=_port_mesh(n))
    _equal_mw(got, jpar.sharded_canonical_count_mw(seq.tobytes(), K=K, mesh=jpar.data_mesh(n)))
    assert got[1].sum() > 0


def test_sharded_multiword_k80_matches_reference_single_device():
    seq = _dna(3000, 43, n_share=0.01)
    got = tpar.sharded_canonical_count_mw(seq, K=80, mesh=_port_mesh(4))
    _equal_mw(got, jcc.canonical_count_bytes(seq, jcc.CountConfig(K=80)))


def test_sharded_multiword_k32_all_t():
    # K = 32 fills 64 bits: the all-T k-mer's forward register is all ones,
    # the reference's padding value; its canonical form, all-A, is 0
    s = b"T" * 64 + b"ACGTACGTACGTACGTACGTACGTACGTACGTAC"
    got = tpar.sharded_canonical_count_mw(s, K=32, mesh=_port_mesh(4))
    _equal_mw(got, jcc.canonical_count_bytes(s, jcc.CountConfig(K=32)))
    d = dict(zip([int(x) for x in got[0]], got[1].tolist()))
    assert d[0] == 64 - 32 + 1 and (1 << 64) - 1 not in d
    # the same multiset as the reference's sharded count, whose order is
    # not sorted here (ROADMAP F8): it argsorts a list of Python ints, which numpy
    # holds as float64 once a register reaches 2^63, so registers that
    # round to one double keep the order they came in
    want = jpar.sharded_canonical_count_mw(s, K=32, mesh=jpar.data_mesh(4))
    assert dict(zip([int(x) for x in want[0]], want[1].tolist())) == d
    assert [int(x) for x in want[0]] != sorted(int(x) for x in want[0])


def test_sharded_multiword_errors_match_reference():
    mesh, jmesh = _port_mesh(2), jpar.data_mesh(2)
    for count, m in ((tpar.sharded_canonical_count_mw, mesh), (jpar.sharded_canonical_count_mw, jmesh)):
        k, c = count("ACG", K=33, mesh=m)
        assert k.size == 0 and k.dtype == object and c.dtype == np.int64
        with pytest.raises(ValueError):
            count("ACGT" * 100, K=31, mesh=m)
    with pytest.raises(EncodeError):
        tpar.sharded_canonical_count_mw("ACGT!" * 100, K=33, mesh=mesh)
    with pytest.raises(JaxEncodeError):
        jpar.sharded_canonical_count_mw("ACGT!" * 100, K=33, mesh=jmesh)
    # a bucket overflow raises
    seq = _dna(3000, 44, n_share=0.0).tobytes()
    with pytest.raises(RuntimeError, match="overflow"):
        tpar.sharded_canonical_count_mw(seq, K=40, mesh=_port_mesh(4), bucket_factor=0.05)


@pytest.mark.parametrize(
    "K,bps", [(K, 2) for K in (32, 33, 47, 48, 63, 64, 80, 100)] + [(K, 8) for K in (8, 9, 16, 31, 32)]
)
def test_fx_hash_mw_matches_reference(K, bps):
    rng = np.random.default_rng(K * bps)
    W, bits = n_words(K, bps), bps * K
    vals = [int.from_bytes(rng.bytes(16), "big") % (1 << bits) for _ in range(300)] + [0, (1 << bits) - 1]
    words = np.array(
        [[(v >> (62 * (W - 1 - p))) & ((1 << 62) - 1) for v in vals] for p in range(W)], dtype=np.int64
    )
    limbs = words_to_jax(torch.from_numpy(words), K, bps)
    hh, hl = jax_fx_hash_mw(tuple(jnp.asarray(x) for x in limbs), K, bps)
    want = hashes_from_jax(np.asarray(hh), np.asarray(hl))
    assert n_limbs(K, bps) == jax_n_limbs(K, bps)
    assert torch.equal(fx_hash_mw(torch.from_numpy(words), K, bps), want)


# ---------------------------------------------------------------- the port alone


@pytest.mark.parametrize("n", range(1, 9))
def test_world_sizes_equal_one_device(n):
    seq = _dna(3000, 20 + n, n_share=0.01)
    one = tcc.canonical_count_bytes(seq, tcc.CountConfig(K=21), device="cpu")
    for chunk in (1 << 20, 211):
        _equal(tpar.sharded_canonical_count(seq, tpar.ShardedCountConfig(K=21, chunk_size=chunk),
                                            _port_mesh(n)), one)
    _equal_mw(tpar.sharded_canonical_count_mw(seq, K=50, mesh=_port_mesh(n)),
              tcc.canonical_count_bytes(seq, tcc.CountConfig(K=50), device="cpu"))
    clean = seq.copy()
    clean[clean == ord("N")] = ord("C")
    got = tpar.sharded_minimizer_select(clean, 11, 7, _port_mesh(n))
    want = textract.minimizer_select(clean, 11, 7, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("K", [21, 50])
def test_a_rank_with_no_window(K):
    # rank 1's slab is all N, so on the streamed route its folded table is empty
    seq = np.concatenate([_dna(1000, 60), np.full(1000, ord("N"), np.uint8), _dna(2000, 61)])
    one = tcc.canonical_count_bytes(seq, tcc.CountConfig(K=K), device="cpu")
    if K <= 31:
        _equal(tpar.sharded_canonical_count(seq, tpar.ShardedCountConfig(K=K, chunk_size=211), _port_mesh(4)), one)
    else:
        _equal_mw(tpar.sharded_canonical_count_mw(seq, K=K, mesh=_port_mesh(4)), one)


def test_explicit_mesh_with_repeated_devices():
    seq = _dna(2000, 30)
    mesh = tpar.Mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.ranks == (0, 1, 2, 3) and mesh.group is None
    _equal(tpar.sharded_canonical_count(seq, tpar.ShardedCountConfig(K=11), mesh),
           tcc.canonical_count_bytes(seq, tcc.CountConfig(K=11), device="cpu"))


def test_mesh_transport_in_one_process():
    mesh = _port_mesh(3)
    buckets = [torch.arange(12).reshape(3, 2, 2) + 100 * r for r in range(3)]
    received = mesh.all_to_all(buckets)
    for r in range(3):
        for s in range(3):
            assert torch.equal(received[r][s], buckets[s][r])
    assert mesh.sum([torch.tensor([1, 2]), torch.tensor([3, 4]), torch.tensor([5, 6])]) == [9, 12]
    assert mesh.max([torch.tensor(4), torch.tensor(9), torch.tensor(2)]) == [9]
    parts = mesh.gather([torch.ones((r, 2), dtype=torch.int64) for r in range(3)])
    assert [p.shape[0] for p in parts] == [0, 1, 2]


def test_data_mesh_errors_and_no_fallback():
    assert _port_mesh(None).size == 1
    with pytest.raises(ValueError):
        tpar.data_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        tpar.data_mesh(2, device="meta")
    with pytest.raises(ValueError):
        tpar.Mesh([])
    if not torch.cuda.is_available():
        # a CUDA mesh without a GPU raises; nothing carries on on the CPU
        with pytest.raises(RuntimeError):
            tpar.data_mesh()
        with pytest.raises(RuntimeError):
            tpar.Mesh(["cuda:0"])
        with pytest.raises(RuntimeError):
            tpar.sharded_canonical_count("ACGT" * 40, tpar.ShardedCountConfig(K=5))
    else:
        with pytest.raises(ValueError):
            tpar.data_mesh(torch.cuda.device_count() + 1)
