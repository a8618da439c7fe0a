"""kslam_tpu_torch.ops.join and the port's join tables against the JAX
reference (kslam_tpu.ops.join, kslam_tpu.db.kmer_index): the bucket,
prefix-window and prefix-rows lookups on the same numpy-seeded keys,
escaped buckets and uncovered prefix runs included, give equal (lo, hi,
uncovered); the prefix and bucket tables and the padded join columns
are equal; and either package reads the bucket table the other cached.
Exact equality throughout (integer outputs)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kslam_tpu.db.genbank import GenbankEntry, GenbankIndex
from kslam_tpu.db.kmer_index import KmerIndex as JKmerIndex
from kslam_tpu.ops import join as jjoin
from kslam_tpu_torch.db import kmer_index
from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.ops import join, kmers

torch.set_num_threads(1)

ALL_ONES = np.uint64(2**64 - 1)
# words at the edges of the key encoding: near 0, across the sign flip
# (2^63), and near 2^64 - 1, where t = 2^32 - 1 maps to v = 2^32 (the
# CDF map's clamped edge)
EDGES = np.array([0, 1, 2, 2**32 - 1, 2**32, 2**63 - 2, 2**63 - 1,
                  2**63, 2**63 + 1, 2**64 - 2**32, 2**64 - 3, 2**64 - 2],
                 dtype=np.uint64)


def _index_words(case, rng):
    """Sorted uint64 index words (no all-ones sentinel among them)."""
    km = rng.integers(0, 2**63, 5000, dtype=np.uint64)
    if case == "heavy_run":
        # one k-mer 300 times: its bucket escapes (tests/test_join.py)
        km = np.concatenate([km, np.full(300, km[100])])
    elif case == "edges":
        km = np.concatenate([km, km | np.uint64(2**63), EDGES,
                             np.repeat(EDGES[:3], 20)])
    return np.sort(km)


def _queries(km, rng):
    vals, counts = np.unique(km, return_counts=True)
    return np.concatenate([
        rng.choice(km, 400),
        rng.integers(0, 2**64 - 1, 400, dtype=np.uint64),
        EDGES, [vals[counts.argmax()], km[0], km[-1]]]).astype(np.uint64)


def _idx(km, cls):
    z = np.zeros(len(km), np.int32)
    return cls(km, z, z, np.zeros(len(km), bool))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _keys(words):
    return torch.as_tensor(kmers.keys_from_words_np(words))


@pytest.mark.parametrize("case", ["random", "heavy_run", "edges"])
def test_lookup_bucket_matches_jax(case):
    rng = np.random.default_rng(11)
    km = _index_words(case, rng)
    q = _queries(km, rng)
    tbl, bits = _idx(km, KmerIndex).bucket_table()
    jtbl, jbits = _idx(km, JKmerIndex).bucket_table()
    assert bits == jbits
    np.testing.assert_array_equal(tbl, jtbl)
    want = jax.jit(jjoin.lookup_bucket, static_argnames="bits")(
        jnp.asarray(jtbl), jnp.asarray(q), bits=jbits)
    got = join.lookup_bucket(torch.from_numpy(tbl), _keys(q), bits)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    lo, hi, unc = (x.numpy() for x in got)
    covered = unc == 0
    np.testing.assert_array_equal(lo[covered],
                                  np.searchsorted(km, q[covered], "left"))
    np.testing.assert_array_equal(hi[covered],
                                  np.searchsorted(km, q[covered], "right"))
    if case == "heavy_run":
        vals, counts = np.unique(km, return_counts=True)
        assert unc[q == vals[counts.argmax()]].min() >= 300
        assert covered.mean() > 0.8


def _prefix_case(bits, window, rng):
    """Index words whose top `bits` collide in runs, one run 3 windows
    long (uncovered), padded as the join expects; returns (sorted words,
    padded words, pstart)."""
    m = 3000
    km = (rng.integers(0, 1 << bits, m, dtype=np.uint64)
          << np.uint64(64 - bits)) | rng.integers(0, 4, m, dtype=np.uint64)
    km = np.sort(np.concatenate([km, np.full(3 * window, km[7])]))
    counts = np.bincount((km >> np.uint64(64 - bits)).astype(np.int64),
                         minlength=1 << bits)
    assert counts.max() > 2 * window
    pstart = np.zeros((1 << bits) + 1, np.int32)
    np.cumsum(counts, out=pstart[1:])
    npad = 2 * window + (-(len(km) + 2 * window)) % window
    padded = np.concatenate([km, np.full(npad, ALL_ONES)])
    return km, padded, pstart


def _check_bounds(got, want, km, q):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    lo, hi, unc = (x.numpy() for x in got)
    covered = unc == 0
    assert 0 < covered.sum() < len(q)
    np.testing.assert_array_equal(lo[covered],
                                  np.searchsorted(km, q[covered], "left"))
    np.testing.assert_array_equal(hi[covered],
                                  np.searchsorted(km, q[covered], "right"))


@pytest.mark.parametrize("bits,window", [(8, 64), (10, 32), (12, 16)])
def test_lookup_prefix_window_matches_jax(bits, window):
    rng = np.random.default_rng(11)
    km, padded, pstart = _prefix_case(bits, window, rng)
    q = np.concatenate([rng.choice(km, 500), EDGES,
                        rng.integers(0, 2**64 - 1, 500, dtype=np.uint64)])
    want = jjoin.lookup_prefix_window(
        jnp.asarray(padded), jnp.asarray(pstart), jnp.asarray(q), bits,
        window)
    got = join.lookup_prefix_window(_keys(padded), torch.as_tensor(pstart),
                                    _keys(q), bits, window)
    _check_bounds(got, want, km, q)


@pytest.mark.parametrize("bits,window", [(8, 32), (10, 16)])
def test_prefix_rows_match_jax(bits, window):
    rng = np.random.default_rng(3)
    km, padded, pstart = _prefix_case(bits, window, rng)
    q = np.concatenate([rng.choice(km, 500), EDGES,
                        rng.integers(0, 2**64 - 1, 500, dtype=np.uint64)])
    jrows, jp2 = jax.jit(jjoin.build_prefix_rows, static_argnames="window")(
        jnp.asarray(padded), jnp.asarray(pstart), window=window)
    rows, p2 = join.build_prefix_rows(_keys(padded), torch.as_tensor(pstart),
                                      window)
    np.testing.assert_array_equal(rows.numpy(),
                                  kmers.keys_from_words_np(np.asarray(jrows)))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(jp2))
    want = jjoin.lookup_prefix_rows(jrows, jp2, jnp.asarray(q), bits, window)
    got = join.lookup_prefix_rows(rows, p2, _keys(q), bits, window)
    _check_bounds(got, want, km, q)


def test_lookups_in_slices_equal_one_pass(monkeypatch):
    """The query slices bound the temporaries and change no result."""
    rng = np.random.default_rng(5)
    km, padded, pstart = _prefix_case(10, 32, rng)
    tbl, bits = _idx(km, KmerIndex).bucket_table()
    q = _keys(np.concatenate([rng.choice(km, 700),
                              rng.integers(0, 2**63, 300, dtype=np.uint64)]))
    calls = (
        lambda: join.lookup_bucket(torch.from_numpy(tbl), q, bits),
        lambda: join.lookup_prefix_window(_keys(padded),
                                          torch.as_tensor(pstart), q, 10, 32))
    whole = [f() for f in calls]
    monkeypatch.setattr(join, "SLICE_QUERIES", 64)
    monkeypatch.setattr(join, "SLICE_ELEMS", 64 * 64)
    for f, want in zip(calls, whole):
        for a, b in zip(f(), want):
            assert torch.equal(a, b)


def _genome_index(repeat: bool):
    rng = np.random.default_rng(13)
    unit = "".join(rng.choice(list("ACGT"), 40))
    genomes = ["".join(rng.choice(list("ACGT"), 400))
               + (unit * 30 if repeat else "") for _ in range(4)]
    gindex = GenbankIndex([GenbankEntry(bases=g) for g in genomes])
    jk = JKmerIndex.build(gindex)
    return jk, KmerIndex(jk.kmers, jk.entry_id, jk.offset, jk.rc)


@pytest.mark.parametrize("repeat", [False, True], ids=["uniform", "repeat"])
def test_tables_and_join_columns_match_jax(repeat):
    jk, tk = _genome_index(repeat)
    for got, want in zip(tk.prefix_table(), jk.prefix_table()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tk.bucket_table(), jk.bucket_table()):
        np.testing.assert_array_equal(got, want)
    assert tk._fingerprint() == jk._fingerprint()
    keys, pack, pstart, bits, window = kmer_index.join_columns(tk)
    jkm, jeid, joff, jrc, jpstart, jbits, jwindow = jk.device_arrays()
    np.testing.assert_array_equal(keys,
                                  kmers.keys_from_words_np(np.asarray(jkm)))
    np.testing.assert_array_equal(pstart, np.asarray(jpstart))
    assert (bits, window) == (jbits, jwindow)
    m = len(tk)
    assert keys.shape[0] >= m + 2 * window and keys.shape[0] % window == 0
    np.testing.assert_array_equal(pack[m:], 0)
    np.testing.assert_array_equal(
        pack[:m].view(np.uint64),
        (jk.entry_id.astype(np.uint64) << np.uint64(33))
        | (jk.offset.astype(np.uint64) << np.uint64(1))
        | jk.rc.astype(np.uint64))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bucket_cache_is_shared(tmp_path, writer):
    """A table one package cached in the DB directory is memory-mapped by
    the other; an index rebuilt in place (new fingerprint) rebuilds the
    table and rewrites the cache."""
    jk, tk = _genome_index(True)
    write, read = (jk, tk) if writer == "jax" else (tk, jk)
    read_cls = type(read)
    write.cache_dir = str(tmp_path)
    tbl, bits = write.bucket_table()
    assert not isinstance(tbl, np.memmap)
    assert os.path.exists(tmp_path / "bucket_table.npy")
    reader = read_cls(read.kmers, read.entry_id, read.offset, read.rc)
    reader.cache_dir = str(tmp_path)
    got, got_bits = reader.bucket_table()
    assert isinstance(got, np.memmap) and got_bits == bits
    np.testing.assert_array_equal(got, tbl)
    # the same length, other k-mers: the cached table is stale
    km2 = np.sort(read.kmers ^ np.uint64(0x5A5A))
    rebuilt = read_cls(km2, read.entry_id, read.offset, read.rc)
    rebuilt.cache_dir = str(tmp_path)
    assert rebuilt._fingerprint() != reader._fingerprint()
    fresh, _ = rebuilt.bucket_table()
    assert not isinstance(fresh, np.memmap)
    np.testing.assert_array_equal(
        fresh, read_cls(km2, read.entry_id, read.offset,
                        read.rc).bucket_table()[0])
    again = type(write)(km2, read.entry_id, read.offset, read.rc)
    again.cache_dir = str(tmp_path)
    cached, _ = again.bucket_table()
    assert isinstance(cached, np.memmap)
    np.testing.assert_array_equal(cached, fresh)
