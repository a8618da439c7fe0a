"""The join's sector table (kslam_tpu_torch/db/sector_table.py) and its
kernel (csrc/join.cu sector_join_kernel) off the card: a numpy model of
the table's layout, built another way than the torch builder (bincount
and cumsum for the starts, a scatter of each key into its slot), equal
to the builder at several slice sizes; the table equal to the one
derived from the JAX package's bucket table at the same bits; a numpy
model of the kernel's per-query steps (the __umulhi CDF map, the two
16 B lanes of one sector, the slot words, tier 2's binary search of an
escaped run) equal to lookup_sector_plain and, with tier 2, to the CPU
match.join_bounds, which equals searchsorted_both and the JAX package's
exact join on every kept query; rows of every count 0..6, escapes by
count and by delta, the clamp at t = 2^32 - 1, the all-ones word and the
sentinels.  Also the table's bits rule, DeviceDB.from_index (the table
built from the uploaded keys, no bucket_table.npy read or written), the
wrappers' operand checks and the CPU dispatch.  The kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py phases 3 and
10)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kslam_tpu.db.kmer_index import KmerIndex as JKmerIndex
from kslam_tpu.ops import join as jjoin
from kslam_tpu_torch.db import sector_table
from kslam_tpu_torch.db.genbank import GenbankEntry, GenbankIndex
from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.eval import join_cases
from kslam_tpu_torch.ops import join, join_cuda, kmers, match
from kslam_tpu_torch.pipeline import align
from tests.test_torch_join_kernel import _exact_bounds, _umulhi

torch.set_num_threads(1)

U64, U32 = np.uint64, np.uint32
FLIP = U64(2**63)
ALL_ONES = join_cases.ALL_ONES
ESCAPE = 1 << 30                   # the bucket table's count flag
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kslam_tpu_torch", "csrc", "join.cu")
ST = sector_table


def model_sector_build(words, bits: int):
    """The sector table of the sorted index words, in numpy: each row's
    count by bincount, its start by cumsum, each key scattered into its
    slot; rows of more than four keys, or with a t-delta >= 2^12, escape
    and keep only their start, run length and escape bit."""
    m, n_rows = len(words), 1 << bits
    rows = join_cases.bucket_of_words(words, bits)
    counts = np.bincount(rows, minlength=n_rows)
    start = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    t = (words >> U64(32)).astype(np.int64)
    low = (words & U64(0xFFFFFFFF)).astype(np.int64)
    slot = np.arange(m) - start[rows]
    nonempty = counts > 0
    t_base = np.zeros(n_rows, np.int64)
    t_base[nonempty] = t[start[:-1][nonempty]]
    delta = t - t_base[rows]
    escape = counts > ST.SLOTS
    escape[rows[delta >= 1 << ST.DELTA_BITS]] = True
    ok = (slot < ST.SLOTS) & ~escape[rows]
    tbl = np.zeros((n_rows, 8), np.int64)
    tbl[:, 0] = start[:-1]
    tbl[:, 1] = np.where(nonempty & ~escape, t_base, 0)
    tbl[rows[ok], 2 + slot[ok]] = low[ok]
    tbl[escape, 2] = counts[escape]
    d = np.zeros((n_rows, ST.SLOTS), np.int64)
    d[rows[ok], slot[ok]] = delta[ok]
    tbl[:, 6] = d[:, 0] | (d[:, 1] << ST.DELTA_BITS)
    tbl[:, 7] = (d[:, 2] | (d[:, 3] << ST.DELTA_BITS) |
                 (np.where(escape, 0, counts) << ST.COUNT_SHIFT) |
                 (escape.astype(np.int64) << ST.ESCAPE_SHIFT))
    return tbl.astype(U32).view(np.int32)


def sector_from_bucket(btbl):
    """The sector table implied by the reference's bucket table at the
    same bits (KmerIndex.bucket_table: c0 start, c1 count | ESCAPE, c2
    t_base, c3..c6 t-deltas, c7..c14 low words): the same start, the
    first four slots of a row of at most four keys, and an escape where
    the reference escapes or the row holds more than four keys."""
    b = btbl.astype(np.int64)
    cnt = b[:, 1] & (ESCAPE - 1)
    escape = (b[:, 1] >= ESCAPE) | (cnt > ST.SLOTS)
    s = np.arange(ST.SLOTS)
    keep = (s[None, :] < cnt[:, None]) & ~escape[:, None]
    d = np.where(keep, (b[:, 3 + s // 2] >> (ST.DELTA_BITS * (s % 2)))
                 & ((1 << ST.DELTA_BITS) - 1), 0)
    tbl = np.zeros((len(b), 8), np.int64)
    tbl[:, 0] = b[:, 0]
    tbl[:, 1] = np.where((cnt > 0) & ~escape, b[:, 2] & 0xFFFFFFFF, 0)
    tbl[:, 2:6] = np.where(keep, b[:, 7:11] & 0xFFFFFFFF, 0)
    tbl[escape, 2] = cnt[escape]
    tbl[:, 6] = d[:, 0] | (d[:, 1] << ST.DELTA_BITS)
    tbl[:, 7] = (d[:, 2] | (d[:, 3] << ST.DELTA_BITS) |
                 (np.where(escape, 0, cnt) << ST.COUNT_SHIFT) |
                 (escape.astype(np.int64) << ST.ESCAPE_SHIFT))
    return tbl.astype(U32).view(np.int32)


def model_sector_join(tbl, keys, bits: int, keys_idx=None, q_ok=None):
    """sector_join_kernel's steps for every query, in numpy; with q_ok
    (and the index keys) its tier 2 too, whose launch writes no
    uncovered (returned here all the same)."""
    word = keys.view(U64) ^ FLIP
    t = (word >> U64(32)).astype(U32)
    v = U64(2) * t.astype(U64) - _umulhi(t, t)
    row = np.minimum(v >> U64(32 - bits), U64((1 << bits) - 1))
    r = tbl[row.astype(np.int64)]
    a, b = r[:, 0:4], r[:, 4:8]          # the sector's two 16 B lanes
    escaped = ((b[:, 3] >> ST.ESCAPE_SHIFT) & 1) == 1
    cnt = (b[:, 3] >> ST.COUNT_SHIFT) & 7
    t_base = a[:, 1].view(U32)
    lows = [a[:, 2], a[:, 3], b[:, 0], b[:, 1]]
    deltas = [b[:, 2], b[:, 3]]
    lt = np.zeros(len(keys), np.int64)
    eq = np.zeros(len(keys), np.int64)
    for s in range(ST.SLOTS):
        # int32 >> is arithmetic, then the 12-bit mask
        delta = ((deltas[s // 2] >> (ST.DELTA_BITS * (s % 2)))
                 & ((1 << ST.DELTA_BITS) - 1)).astype(U32)
        slot = ((t_base + delta).astype(U64) << U64(32)) | \
            lows[s].view(U32).astype(U64)
        in_run = s < cnt
        lt += in_run & (slot < word)
        eq += in_run & (slot == word)
    lo = a[:, 0].astype(np.int64) + np.where(escaped, 0, lt)
    hi = lo + np.where(escaped, 0, eq)
    run = a[:, 2].astype(np.int64)
    if q_ok is not None:
        sel = escaped & (run > 0) & q_ok
        start = a[sel, 0].astype(np.int64)
        lo[sel], hi[sel] = _exact_bounds(keys_idx.view(U64) ^ FLIP, start,
                                         start + run[sel], word[sel])
    return (lo, hi, np.where(escaped, run, 0).astype(np.int32), row, v,
            escaped, cnt)


def _keys(words):
    return torch.as_tensor(kmers.keys_from_words_np(words))


def _built(words, bits: int, **slices):
    """The torch builder's table of the sorted words, from their
    sentinel-padded keys, as numpy."""
    padded = join_cases.sentinel_padded(words, 16)
    return sector_table.build(_keys(padded), len(words), bits,
                              **slices).numpy()


def _assert_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _masks(rng, n: int):
    """q_ok patterns: all kept, none kept, a random half."""
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "random": rng.random(n) < 0.5}


@pytest.mark.parametrize("slices", [{}, dict(slice_keys=777,
                                             slice_rows=1000),
                                    dict(slice_keys=5, slice_rows=4096)],
                         ids=["default", "odd", "small"])
@pytest.mark.parametrize("bits", [16, 21])
def test_sector_build_matches_model(bits, slices):
    """The torch builder equals the numpy model at any slicing (the
    sentinels after the keys in no row), and its rows reach every count
    0..4 covered, 5, 6 and the long run escaped, the escape by delta (a
    last delta of 2^12 - 1 covered) and the clamped last row."""
    rng = np.random.default_rng(29)
    words = join_cases.sector_index_words(rng, bits=bits)
    got = _built(words, bits, **slices)
    np.testing.assert_array_equal(got, model_sector_build(words, bits))
    assert got.shape == (1 << bits, 8) and got.dtype == np.int32
    info = got[:, 7]
    escaped = ((info >> ST.ESCAPE_SHIFT) & 1) == 1
    cnt = (info >> ST.COUNT_SHIFT) & 7
    runs = np.append(got[1:, 0], len(words)) - got[:, 0]
    np.testing.assert_array_equal(cnt[~escaped], runs[~escaped])
    np.testing.assert_array_equal(got[escaped, 2], runs[escaped])
    assert set(range(5)) <= set(cnt[~escaped].tolist())
    assert {5, 6} <= set(runs[escaped].tolist())
    assert runs[escaped].max() >= 301
    assert (escaped & (runs <= ST.SLOTS)).any()          # by delta
    d3 = (info >> ST.DELTA_BITS) & ((1 << ST.DELTA_BITS) - 1)
    assert ((cnt == 4) & (d3 == (1 << ST.DELTA_BITS) - 1)).any()
    last = join_cases.bucket_of_words(join_cases.EDGES, bits)
    assert last.max() == (1 << bits) - 1 and runs[-1] > 0


@pytest.mark.parametrize("bits", [10, 16, 21])
def test_sector_table_matches_jax_bucket_table(bits):
    """The sector table equals the one the JAX package's bucket table at
    the same bits implies, row for row (at 10 bits most rows escape)."""
    rng = np.random.default_rng(53)
    if bits == 10:
        words = np.sort(np.concatenate([
            rng.integers(0, 2**64 - 1, 6000, dtype=np.uint64),
            join_cases.EDGES, np.full(40, join_cases.EDGES[5])]))
    else:
        words = join_cases.sector_index_words(rng, bits=bits)
    z = np.zeros(len(words), np.int32)
    jtbl, jbits = JKmerIndex(words, z, z, np.zeros(len(words), bool)) \
        .bucket_table(bits=bits)
    assert jbits == bits
    got = _built(words, bits)
    np.testing.assert_array_equal(got, sector_from_bucket(np.asarray(jtbl)))
    escaped = ((got[:, 7] >> ST.ESCAPE_SHIFT) & 1) == 1
    if bits == 10:
        assert escaped.mean() > 0.5


@pytest.mark.parametrize("bits", [16, 21])
def test_sector_model_matches_plain(bits):
    """The kernel model equals lookup_sector_plain on every query (index
    words, their neighbours, random words, the edge words, the all-ones
    word), and a covered query's bounds are the exact search's."""
    rng = np.random.default_rng(31)
    words = join_cases.sector_index_words(rng, bits=bits)
    tbl = _built(words, bits)
    q = join_cases.queries_for(words, rng)
    keys = kmers.keys_from_words_np(q)
    lo, hi, unc, row, v, escaped, cnt = model_sector_join(tbl, keys, bits)
    plain = join.lookup_sector_plain(torch.from_numpy(tbl),
                                     torch.as_tensor(keys), bits)
    _assert_equal((lo, hi, unc), plain)
    # what the queries reached: every count 0..4 of a covered row, both
    # escapes, the clamped CDF edge, both halves of the word space
    assert set(range(5)) <= set(cnt[~escaped].tolist())
    assert (unc[escaped] > ST.SLOTS).any()
    assert (escaped & (unc <= ST.SLOTS)).any()
    assert (v == 2**32).any() and (row == (1 << bits) - 1).any()
    assert (q < FLIP).any() and (q >= FLIP).any()
    assert (q == ALL_ONES).any()
    cov = ~escaped & (q != ALL_ONES)
    np.testing.assert_array_equal(lo[cov], np.searchsorted(words, q[cov],
                                                           "left"))
    np.testing.assert_array_equal(hi[cov], np.searchsorted(words, q[cov],
                                                           "right"))
    assert (unc[~escaped] == 0).all()


@pytest.mark.parametrize("mask", ["all", "none", "random"])
@pytest.mark.parametrize("bits", [16, 21])
def test_sector_tier2_model_matches_join_bounds(bits, mask):
    """sector_join with tier 2 (one launch of match.join_bounds on the
    card) equals the CPU join_bounds on every query, for every q_ok
    pattern: escaped rows of both kinds searched in their run, the
    all-ones word's upper bound at the padded keys' end."""
    rng = np.random.default_rng(71)
    words = join_cases.sector_index_words(rng, bits=bits)
    tbl = _built(words, bits)
    padded = join_cases.sentinel_padded(words, 16)
    keys_idx = kmers.keys_from_words_np(padded)
    q = join_cases.queries_for(words, rng)
    keys = kmers.keys_from_words_np(q)
    q_ok = _masks(rng, len(q))[mask]
    lo, hi, unc = model_sector_join(tbl, keys, bits, keys_idx, q_ok)[:3]
    want = match.join_bounds(torch.as_tensor(keys), torch.as_tensor(q_ok),
                             torch.as_tensor(keys_idx),
                             idx_sector=torch.from_numpy(tbl),
                             sector_bits=bits)
    _assert_equal((lo, hi), want)
    tier2 = q_ok & (unc > 0)
    if mask != "none":
        assert tier2.any()
        np.testing.assert_array_equal(
            lo[tier2], np.searchsorted(padded, q[tier2], "left"))
        np.testing.assert_array_equal(
            hi[tier2], np.searchsorted(padded, q[tier2], "right"))


@pytest.mark.parametrize("bits", [8, 10, 21])
def test_sector_join_bounds_match_jax(bits):
    """The fused join_bounds' plain version over the sector table equals
    searchsorted_both and the JAX package's exact join
    (searchsorted_blocked_both) on every kept query, at 8 and 10 bits
    with most kept queries sent to tier 2; where the table covers a
    query its lookup equals the JAX package's lookup_bucket at the same
    bits."""
    rng = np.random.default_rng(59)
    words = np.sort(np.concatenate([
        rng.integers(0, 2**64 - 1, 8000, dtype=np.uint64),
        join_cases.EDGES, np.full(300, join_cases.EDGES[7])]))
    padded = join_cases.sentinel_padded(words, 16)
    q = np.concatenate([join_cases.queries_for(words, rng),
                        rng.choice(words, 2000)])
    q_ok = (q != ALL_ONES) & (rng.random(len(q)) < 0.9)
    tbl = _built(words, bits)
    qk, okt, kt = _keys(q), torch.as_tensor(q_ok), _keys(padded)
    lo, hi = match.join_bounds(qk, okt, kt, idx_sector=torch.from_numpy(tbl),
                               sector_bits=bits)
    exact = join.searchsorted_both(kt, qk)
    want = jax.jit(jjoin.searchsorted_blocked_both)(jnp.asarray(padded),
                                                    jnp.asarray(q))
    for got, ex, jx in zip((lo, hi), exact, want):
        np.testing.assert_array_equal(got.numpy()[q_ok], ex.numpy()[q_ok])
        np.testing.assert_array_equal(got.numpy()[q_ok],
                                      np.asarray(jx).astype(np.int64)[q_ok])
    look = join.lookup_sector(torch.from_numpy(tbl), qk, bits)
    escaped = look[2].numpy() > 0
    z = np.zeros(len(words), np.int32)
    jtbl, _ = JKmerIndex(words, z, z, np.zeros(len(words), bool)) \
        .bucket_table(bits=bits)
    jlook = jax.jit(jjoin.lookup_bucket, static_argnames="bits")(
        jnp.asarray(jtbl), jnp.asarray(q), bits=bits)
    for got, jx in zip(look[:2], jlook[:2]):
        np.testing.assert_array_equal(
            got.numpy()[~escaped], np.asarray(jx).astype(np.int64)[~escaped])
    share = (escaped & q_ok).sum() / q_ok.sum()
    if bits <= 10:
        assert share > 0.5
    else:
        assert 0 < share < 0.5


@pytest.mark.parametrize("n_keys,bits", [
    (0, 21), (1, 21), (2**20, 21), (5 * 2**19, 21), (5 * 2**19 + 1, 22),
    (10_274_832, 23), (5 * 2**22, 24), (5 * 2**22 + 1, 25),
    (99_999_984, 27), (2**27, 27), (2**28, 27), (2**33, 27)])
def test_default_bits(n_keys, bits):
    """The fewest rows with at most 1.25 keys each on average (2^bits >=
    0.8 keys), within 21..27: 2^27 rows for phase 10's 99,999,984 keys
    and 2^23 for its repeat-rich index's 10,274,832."""
    assert sector_table.default_bits(n_keys) == bits
    if 21 < bits < 27:
        assert 2**bits * 5 >= 4 * n_keys > 2**(bits - 1) * 5


def _small_db(tmp_path):
    """A saved DB of two genomes and its loaded index (cache_dir set)."""
    rng = np.random.default_rng(5)
    gindex = GenbankIndex([GenbankEntry(
        bases="".join(rng.choice(list("ACGT"), 3000))) for _ in range(2)])
    KmerIndex.build(gindex).save(str(tmp_path))
    kidx = KmerIndex.load(str(tmp_path))
    assert kidx.cache_dir == str(tmp_path)
    return gindex, kidx


@pytest.mark.parametrize("cache", ["none", "poisoned"])
def test_device_db_builds_the_table_from_its_keys(tmp_path, monkeypatch,
                                                  cache):
    """DeviceDB.from_index builds the sector table from the keys it
    uploaded, at default_bits, equal to the model of the index words; it
    neither calls KmerIndex.bucket_table nor reads or writes
    bucket_table.npy / bucket_meta.json, whether the DB directory has no
    cache or a poisoned one; --no-prefix-rows builds no table."""
    gindex, kidx = _small_db(tmp_path)
    files = [tmp_path / "bucket_table.npy", tmp_path / "bucket_meta.json"]
    if cache == "poisoned":
        for f in files:
            f.write_bytes(b"not a table")
    before = {f: f.read_bytes() if f.exists() else None for f in files}

    def refuse(*args, **kwargs):
        raise AssertionError("DeviceDB read the host bucket table")
    monkeypatch.setattr(KmerIndex, "bucket_table", refuse)
    db = align.DeviceDB.from_index(gindex, kidx, "cpu")
    m = len(kidx)
    assert db.sector_bits == sector_table.default_bits(m) == 21
    np.testing.assert_array_equal(
        db.sector.numpy(), model_sector_build(np.asarray(kidx.kmers),
                                              db.sector_bits))
    assert {f: f.read_bytes() if f.exists() else None
            for f in files} == before
    tables = db.join_tables()
    assert tables["idx_sector"] is db.sector and \
        tables["sector_bits"] == db.sector_bits
    bare = align.DeviceDB.from_index(gindex, kidx, "cpu", prefix_rows=False)
    assert bare.sector is None and bare.sector_bits == 0
    assert torch.equal(bare.kmers, db.kmers)


def _sector_operands():
    return (torch.zeros((1 << 4, 8), dtype=torch.int32),
            torch.zeros(10, dtype=torch.int64), 4)


BAD_SECTOR = {
    "tbl_dtype": lambda t, q, b: (t.to(torch.int64), q, b),
    "tbl_rows": lambda t, q, b: (t[1:], q, b),
    "tbl_width": lambda t, q, b: (torch.zeros((16, 16), dtype=torch.int32),
                                  q, b),
    "tbl_non_contiguous": lambda t, q, b: (
        torch.zeros((16, 16), dtype=torch.int32)[:, ::2], q, b),
    "query_dtype": lambda t, q, b: (t, q.to(torch.int32), b),
    "query_non_contiguous": lambda t, q, b: (
        t, torch.zeros(20, dtype=torch.int64)[::2], b),
    "bits_zero": lambda t, q, b: (t, q, 0),
    "bits_33": lambda t, q, b: (t, q, 33),
    "devices_differ": lambda t, q, b: (t, q.to("meta"), b),
}


@pytest.mark.parametrize("case", sorted(BAD_SECTOR))
def test_sector_operand_checks(case):
    args = BAD_SECTOR[case](*_sector_operands())
    with pytest.raises(ValueError):
        join.lookup_sector(*args)
    with pytest.raises(ValueError):
        join_cuda.check_sector(*args)


def test_sector_alignment_check():
    """sector_join reads 32 B rows: a view that starts off that boundary
    is refused before a launch."""
    flat = torch.zeros(17 * 8 + 8, dtype=torch.int32)
    base = (-flat.data_ptr() % 32) // 4
    tbl = flat[base:base + 16 * 8].view(16, 8)
    join_cuda.check_sector(tbl, torch.zeros(3, dtype=torch.int64), 4,
                           aligned=True)
    off = flat[base + 4:base + 4 + 16 * 8].view(16, 8)
    with pytest.raises(ValueError, match="32 B aligned"):
        join_cuda.check_sector(off, torch.zeros(3, dtype=torch.int64), 4,
                               aligned=True)


BAD_BUILD = {
    "keys_int32": lambda k, m, b: (k.to(torch.int32), m, b),
    "keys_2d": lambda k, m, b: (k.reshape(8, 8), m, b),
    "too_many_keys": lambda k, m, b: (k, 65, b),
    "negative_keys": lambda k, m, b: (k, -1, b),
    "bits_zero": lambda k, m, b: (k, m, 0),
    "bits_33": lambda k, m, b: (k, m, 33),
}


@pytest.mark.parametrize("case", sorted(BAD_BUILD))
def test_sector_build_argument_checks(case):
    keys, m, bits = BAD_BUILD[case](torch.zeros(64, dtype=torch.int64),
                                    60, 8)
    with pytest.raises(ValueError):
        sector_table.build(keys, m, bits)


def test_sector_build_of_no_keys():
    """No keys: every row empty, starting at 0."""
    tbl = sector_table.build(torch.full((16,), 2**63 - 1), 0, 4)
    assert tbl.shape == (16, 8) and not tbl.any()


def test_sector_constants_match_the_source():
    """join.cu's sector constants are the table's, the kernel is built
    in both modes and its entry point checks 32 B alignment."""
    src = open(SOURCE).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("kSectorSlots") == ST.SLOTS
    assert const("kCountShift") == ST.COUNT_SHIFT
    assert const("kEscapeShift") == ST.ESCAPE_SHIFT
    assert const("kDeltaBits") == ST.DELTA_BITS
    assert "% 32 != 0" in src and join_cuda.SECTOR_ALIGN == 32
    assert "&sector_join_kernel<true>" in src and \
        "&sector_join_kernel<false>" in src
    assert ST.ROW_WORDS * 4 == join_cuda.SECTOR_ALIGN
    # the count's 3 bits and the escape bit clear the two 12-bit deltas
    assert ST.COUNT_SHIFT == 2 * ST.DELTA_BITS
    assert ST.ESCAPE_SHIFT == ST.COUNT_SHIFT + 3


def test_cpu_sector_dispatch_launches_nothing():
    """On CPU tensors lookup_sector equals its plain version, keeps the
    queries' shape and dtypes, and match.join_bounds through the table
    equals the exact search on kept queries; nothing launches; zero
    queries give empty outputs."""
    rng = np.random.default_rng(43)
    words = join_cases.sector_index_words(rng, n_random=500, bits=16)
    tbl = torch.from_numpy(_built(words, 16))
    keys_idx = _keys(join_cases.sentinel_padded(words, 16))
    before = dict(join_cuda.JOIN_LAUNCHES)
    for n in (0, 1, 257):
        q_np = join_cases.queries_for(words, rng)[:n]
        q = _keys(q_np)
        got = join.lookup_sector(tbl, q, 16)
        want = join.lookup_sector_plain(tbl, q, 16)
        for a, b, dt in zip(got, want, (torch.int64, torch.int64,
                                        torch.int32)):
            assert a.dtype == dt and a.shape == q.shape
            assert torch.equal(a, b)
        q2 = q.reshape(1, -1)
        assert join.lookup_sector(tbl, q2, 16)[0].shape == q2.shape
        q_ok = torch.as_tensor(q_np != ALL_ONES)
        lo, hi = match.join_bounds(q, q_ok, keys_idx, idx_sector=tbl,
                                   sector_bits=16)
        exact = join.searchsorted_both(keys_idx, q)
        assert torch.equal(lo[q_ok], exact[0][q_ok])
        assert torch.equal(hi[q_ok], exact[1][q_ok])
    assert join_cuda.JOIN_LAUNCHES == before


def test_sector_wrappers_refuse_cpu_tensors():
    """The launch functions themselves take CUDA tensors only, in either
    mode; a tensor on another device is refused by the public lookup."""
    tbl, q, bits = _sector_operands()
    keys = torch.zeros(64, dtype=torch.int64)
    q_ok = torch.ones(q.shape, dtype=torch.bool)
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.sector_join(tbl, q, bits)
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.sector_join_bounds(tbl, q, bits, keys, q_ok)
    with pytest.raises(ValueError, match="no join kernel"):
        join.lookup_sector(tbl.to("meta"), q.to("meta"), bits)
