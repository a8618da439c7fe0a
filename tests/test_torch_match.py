"""kslam_tpu_torch.ops.match against the JAX reference match engine:
overlap columns after compaction, the exact chained dedup on a cluster
longer than chain_iters, and the overflow counters under a fanout clip.
Exact equality throughout (integer outputs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kslam_tpu.db.genbank import GenbankEntry, GenbankIndex
from kslam_tpu.db.kmer_index import KmerIndex
from kslam_tpu.ops import kmers as jkmers, match as jmatch
from kslam_tpu_torch.ops import encode, kmers, match

torch.set_num_threads(1)
CHAIN_ITERS = 32


def _setup(seed, repeat=False):
    """Random genomes (optionally with an AC microsatellite that makes one
    dedup cluster of ~300 rows) and reads drawn from them."""
    rng = np.random.default_rng(seed)
    b4 = np.frombuffer(b"ACGT", np.uint8)
    gens = [b4[rng.integers(0, 4, 900)].tobytes().decode() for _ in range(3)]
    if repeat:
        gens[1] = gens[1][:200] + "AC" * 200 + gens[1][200:]
    gindex = GenbankIndex([GenbankEntry(bases=g, taxonomy_id=10 + i)
                           for i, g in enumerate(gens)])
    kidx = KmerIndex.build(gindex)
    n, l = 24, 160
    bases = np.zeros((n, l), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        g = gens[i % 3]
        pos = int(rng.integers(0, len(g) - 150))
        s = bytearray(g[pos:pos + 150].encode())
        for q in rng.integers(0, 150, 2):
            s[q] = int(b4[rng.integers(0, 4)])
        if repeat and i == 0:
            s = bytearray(b"AC" * 75)
        bases[i, :150] = np.frombuffer(bytes(s), np.uint8)
        lengths[i] = 150
    return kidx, bases, lengths


def _run_jax(kidx, bases, lengths, max_matches, capacity):
    kc = encode.kmer_codes_np(bases)
    jk = jkmers.read_kmers_from_codes(jnp.asarray(kc), jnp.asarray(lengths))
    return jmatch.match_overlaps(
        *jk, jnp.asarray(lengths), jnp.asarray(kidx.kmers),
        jnp.asarray(kidx.entry_id), jnp.asarray(kidx.offset),
        jnp.asarray(kidx.rc), max_matches=max_matches, capacity=capacity,
        chain_iters=CHAIN_ITERS)


def _run_torch(kidx, bases, lengths, max_matches, capacity):
    kc = encode.kmer_codes_np(bases)
    tk = kmers.read_kmers_from_codes(torch.as_tensor(kc),
                                     torch.as_tensor(lengths))
    pack = ((kidx.entry_id.astype(np.uint64) << np.uint64(33)) |
            (kidx.offset.astype(np.uint64) << np.uint64(1)) |
            kidx.rc.astype(np.uint64)).view(np.int64)
    return match.match_overlaps(
        *tk, torch.as_tensor(lengths),
        torch.as_tensor(kmers.keys_from_words_np(kidx.kmers)),
        torch.as_tensor(pack), max_matches=max_matches, capacity=capacity)


def _run_both(kidx, bases, lengths, max_matches, capacity):
    return (_run_jax(kidx, bases, lengths, max_matches, capacity),
            _run_torch(kidx, bases, lengths, max_matches, capacity))


def _compacted_columns(res_compact):
    n = int(res_compact.count)
    return [np.asarray(c)[:n] if not isinstance(c, torch.Tensor)
            else c[:n].numpy()
            for c in (res_compact.read_id, res_compact.entry_id,
                      res_compact.rel_pos, res_compact.rc,
                      res_compact.valid)]


def _assert_same_kept(jres, tres):
    jc = jmatch.compact_overlaps(jres, int(jres.count))
    tc = match.compact_overlaps(tres)
    assert int(tc.count) == int(jc.count)
    for a, b in zip(_compacted_columns(tc), _compacted_columns(jc)):
        np.testing.assert_array_equal(a, b)
    assert tc.valid.all()


@pytest.mark.parametrize("seed", [0, 1])
def test_match_compact_columns_match_jax(seed):
    kidx, bases, lengths = _setup(seed)
    jres, tres = _run_both(kidx, bases, lengths, 64, 1 << 14)
    assert int(jres.overflow) == 0 and int(tres.overflow) == 0
    assert int(tres.needed_capacity) == int(jres.needed_capacity)
    assert int(tres.max_fanout) == int(jres.max_fanout)
    _assert_same_kept(jres, tres)
    # the exact-size default (no caps) keeps the same set
    exact = _run_torch(kidx, bases, lengths, None, None)
    _assert_same_kept(jres, exact)


def test_dedup_cluster_longer_than_chain_iters():
    kidx, bases, lengths = _setup(5, repeat=True)
    jres, tres = _run_both(kidx, bases, lengths, 64, 1 << 16)
    assert int(jres.overflow) == 0 and int(jres.needed_dedup) == 0
    # read 0 x entry 1 forms one |delta rel| < 3 cluster far longer than
    # chain_iters, so the reference ran its exact oversized-cluster tail
    v = jres.valid & (jres.read_id == 0) & (jres.entry_id == 1)
    rel = np.asarray(jres.rel_pos)[np.asarray(
        (jres.read_id == 0) & (jres.entry_id == 1))]
    assert len(np.unique(rel)) > 4 * CHAIN_ITERS
    assert int(v.sum()) > 1
    _assert_same_kept(jres, tres)


def test_fanout_clip_sets_overflow_counters():
    kidx, bases, lengths = _setup(5, repeat=True)
    jres, tres = _run_both(kidx, bases, lengths, 4, 1 << 14)
    assert int(jres.overflow) > 0
    for name in ("overflow", "needed_capacity", "max_fanout"):
        assert int(getattr(tres, name)) == int(getattr(jres, name)), name
    _assert_same_kept(jres, tres)
    # a capacity clip counts the dropped pairs too
    jcap, tcap = _run_both(kidx, bases, lengths, 64, 256)
    assert int(jcap.overflow) > 0
    assert int(tcap.overflow) == int(jcap.overflow)


def test_compact_overlaps_keeps_kept_rows_in_order():
    kidx, bases, lengths = _setup(2)
    tres = _run_torch(kidx, bases, lengths, None, None)
    keep = tres.valid.numpy()
    assert 0 < keep.sum() < len(keep)
    tc = match.compact_overlaps(tres)
    assert int(tc.count) == keep.sum() and bool(tc.valid.all())
    for name in ("read_id", "entry_id", "rel_pos", "rc"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      getattr(tres, name).numpy()[keep])


@pytest.fixture(scope="module")
def realistic_join():
    """A repeat-rich index (the copied eval/realistic.py generator: its
    low-complexity tracts and IS copies make prefix runs longer than the
    window and escaped buckets), reads drawn from it, and the reference's
    match_overlaps with the bucket table and its tier 2."""
    from kslam_tpu_torch.eval import realistic
    entries = realistic.make_realistic_entries(n_genomes=2, bp_each=60_000,
                                               seed=7, plasmid_bp=8_000)
    kidx = KmerIndex.build(GenbankIndex([
        GenbankEntry(bases=e.seq.tobytes().decode()) for e in entries]))
    rng = np.random.default_rng(17)
    n, l = 96, 160
    bases = np.zeros((n, l), np.uint8)
    for i in range(n):
        seq = entries[i % len(entries)].seq
        pos = int(rng.integers(0, len(seq) - 150))
        bases[i, :150] = seq[pos:pos + 150]
    lengths = np.full(n, 150, np.int32)
    km, eid, off, rc, pstart, bits, window = kidx.device_arrays()
    tbl, bbits = kidx.bucket_table()
    m = len(kidx)
    pk = np.zeros(km.shape[0], np.uint64)
    pk[:m] = ((kidx.entry_id.astype(np.uint64) << np.uint64(33)) |
              (kidx.offset.astype(np.uint64) << np.uint64(1)) |
              kidx.rc.astype(np.uint64))
    kc = encode.kmer_codes_np(bases)
    jk = jkmers.read_kmers_from_codes(jnp.asarray(kc), jnp.asarray(lengths))
    jres = jmatch.match_overlaps(
        *jk, jnp.asarray(lengths), km, eid, off, rc, max_matches=1 << 12,
        capacity=1 << 18, chain_iters=CHAIN_ITERS,
        idx_bucket=jnp.asarray(tbl), bucket_bits=bbits, tier2_cap=1 << 12,
        idx_pack=jnp.asarray(pk))
    assert int(jres.overflow) == 0
    return kidx, bases, lengths, jres


@pytest.mark.parametrize("backend", ["sector", "bucket", "window", "rows",
                                     "exact"])
def test_join_backends_match_jax(realistic_join, backend):
    """Each join backend of the port, with its exact tier 2, gives the
    reference's seeds row for row after finish_overlaps: the sorted
    (read, entry, relPos, rc) of every pair and the kept set.  The pad of
    idx_pack is poisoned, so an emitted pad slot would show."""
    from kslam_tpu_torch.db import sector_table
    from kslam_tpu_torch.db.kmer_index import join_columns
    from kslam_tpu_torch.ops import join
    kidx, bases, lengths, jres = realistic_join
    keys, pack, pstart, bits, window = join_columns(kidx)
    m = len(kidx)
    pack[m:] = (1 << 29) << 33               # entry id 2^29: no such entry
    keys_t, pstart_t = torch.as_tensor(keys), torch.as_tensor(pstart)
    tables = {"exact": {}, "window": dict(
        idx_pstart=pstart_t, prefix_bits=bits, window=window)}
    tbl, bbits = kidx.bucket_table()
    tables["bucket"] = dict(idx_bucket=torch.from_numpy(tbl),
                            bucket_bits=bbits)
    sbits = sector_table.default_bits(m)
    tables["sector"] = dict(
        idx_sector=sector_table.build(keys_t, m, sbits), sector_bits=sbits)
    rows, p2 = join.build_prefix_rows(keys_t, pstart_t, window)
    tables["rows"] = dict(idx_rows=rows, idx_pstart2=p2, prefix_bits=bits,
                          window=window)
    kc = encode.kmer_codes_np(bases)
    tk = kmers.read_kmers_from_codes(torch.as_tensor(kc),
                                     torch.as_tensor(lengths))
    q = tk[0].reshape(-1)
    # the tables leave queries to tier 2 on this index
    if backend == "sector":
        assert int((join.lookup_sector(tables["sector"]["idx_sector"], q,
                                       sbits)[2] > 0).sum()) > 0
    elif backend == "bucket":
        assert int((join.lookup_bucket(tables["bucket"]["idx_bucket"], q,
                                       bbits)[2] > 0).sum()) > 0
    elif backend == "window":
        assert int((join.lookup_prefix_window(keys_t, pstart_t, q, bits,
                                              window)[2] > 0).sum()) > 0
    seeds = match.expand_seeds(*tk, torch.as_tensor(lengths), keys_t,
                               torch.as_tensor(pack), **tables[backend])
    tres = match.finish_overlaps(*seeds)
    assert int(tres.overflow) == 0
    assert int(tres.needed_capacity) == int(jres.needed_capacity)
    n = int((tres.read_id != match.INT32_MAX).sum())
    assert n == int(jres.needed_capacity) > 0
    for name in ("read_id", "entry_id", "rel_pos", "rc"):
        np.testing.assert_array_equal(
            getattr(tres, name)[:n].numpy(),
            np.asarray(getattr(jres, name))[:n])
    _assert_same_kept(jres, tres)
