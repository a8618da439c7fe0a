"""kslam_tpu_torch device pipeline against the JAX reference: the DB
tensors, phase A (paired and single-end, ASCII and packed reads) column
by column, the chunk-wide phase B, and a chunk split over several device
batches.  Fixture as tests/test_device_path.py; integer outputs, exact
equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kslam_tpu.config import PipelineConfig
from kslam_tpu.db.genbank import GenbankEntry, GenbankIndex
from kslam_tpu.db.kmer_index import KmerIndex
from kslam_tpu.db.taxonomy import TaxonomyDB
from kslam_tpu.io.fastq import ReadBatch
from kslam_tpu.ops import lca as jlca
from kslam_tpu.pipeline import align as jalign, device_path as jdp, \
    pairing as jpairing, run as jrun
from kslam_tpu_torch.db import sector_table
from kslam_tpu_torch.ops import encode, kmers, lca
from kslam_tpu_torch.pipeline import align, device_path, run
from kslam_tpu_torch.utils import metrics
from tests.test_torch_sector_join import sector_from_bucket

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    bases4 = "ACGT"
    taxdb = TaxonomyDB()
    taxdb.parent_of[1] = 1
    taxdb.parent_of[2] = 1
    for t in (10, 11, 12):
        taxdb.parent_of[t] = 2
    for t in taxdb.parent_of:
        taxdb.rank_of[t] = "no rank"
        taxdb.name_of[t] = f"n{t}"
    genomes = []
    for i in range(4):
        genomes.append(GenbankEntry(
            bases="".join(rng.choice(list(bases4), 700)),
            taxonomy_id=[10, 11, 12, 11][i], locus_tag=f"G{i}"))
    gindex = GenbankIndex(genomes)
    kidx = KmerIndex.build(gindex)
    jdb = jalign.DeviceDB.from_index(gindex, kidx, prefix_rows=False)
    tdb = align.DeviceDB.from_index(gindex, kidx, "cpu")

    n_pairs = 24
    comp = str.maketrans("ACGT", "TGCA")
    names, b1, b2 = [], [], []
    for i in range(n_pairs):
        g = genomes[i % 4].bases
        pos = int(rng.integers(0, 700 - 320))
        r1 = list(g[pos:pos + 150])
        r2 = list(g[pos + 170:pos + 320].translate(comp)[::-1])
        for r in (r1, r2):
            for q in rng.integers(0, 150, 3):
                r[q] = bases4[int(rng.integers(0, 4))]
        names.append(f"p{i}")
        b1.append("".join(r1))
        b2.append("".join(r2))
    bases = np.zeros((2 * n_pairs, 160), np.uint8)
    for i, s in enumerate(b1 + b2):
        bases[i, :150] = np.frombuffer(s.encode(), np.uint8)
    batch = ReadBatch(names=names + names, bases=bases,
                      lengths=np.full(2 * n_pairs, 150, np.int32),
                      quality=np.full_like(bases, 73), paired=True)
    return taxdb, gindex, kidx, jdb, tdb, batch


def _single(batch):
    mid = batch.midpoint
    return ReadBatch(names=batch.names[:mid], bases=batch.bases[:mid],
                     lengths=batch.lengths[:mid],
                     quality=batch.quality[:mid], paired=False)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


def test_device_db_tensors_equal_jax(setup):
    taxdb, gindex, kidx, jdb, tdb, batch = setup
    m = len(kidx)
    # both packages pad the index to pow2(M + 2 * window): the all-ones
    # sentinel (int64 max as a key) and zero words
    assert tdb.kmers.shape[0] == np.asarray(jdb.kmers).shape[0] > m
    np.testing.assert_array_equal(
        tdb.kmers.numpy(), kmers.keys_from_words_np(np.asarray(jdb.kmers)))
    np.testing.assert_array_equal(
        tdb.idx_pack.numpy(), np.asarray(jdb.idx_pack).view(np.int64))
    assert np.all(np.asarray(jdb.kmers)[m:] == np.uint64(2**64 - 1))
    _eq(tdb.pstart, jdb.pstart)
    assert (tdb.prefix_bits, tdb.prefix_window) == \
        (jdb.prefix_bits, jdb.prefix_window)
    # the port's DB carries the sector table, built from its keys: the
    # table the reference's bucket table at the same bits implies; the
    # reference's fixture (prefix_rows=False) has no table
    assert tdb.sector_bits == sector_table.default_bits(m)
    assert jdb.bucket is None
    tbl, _ = kidx.bucket_table(bits=tdb.sector_bits)
    _eq(tdb.sector, sector_from_bucket(np.asarray(tbl)))
    _eq(tdb.genome_chunks, jdb.genome_chunks)
    _eq(tdb.entry_offsets, jdb.entry_offsets)
    assert torch.all(tdb.kmers[1:] >= tdb.kmers[:-1])


def _phase_a_both(setup, paired, packed):
    taxdb, gindex, kidx, jdb, tdb, batch = setup
    b = batch if paired else _single(batch)
    mid = b.midpoint if paired else 0
    p = PipelineConfig().sw
    kw = dict(match_s=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
              gap_extend=p.gap_extend, window_len=160, paired=paired)
    if packed:
        x, nbits, kbits = encode.pack_reads_np(b.bases)
        jx = dict(nbits=jnp.asarray(nbits), kbits=jnp.asarray(kbits))
        tx = dict(nbits=torch.as_tensor(nbits), kbits=torch.as_tensor(kbits))
    else:
        x, jx, tx = b.bases, {}, {}
    ja = jdp.phase_a(
        jnp.asarray(x), jnp.asarray(b.lengths), np.int32(mid), jdb.kmers,
        jdb.entry_id, jdb.offset, jdb.rc, jdb.genome_chunks,
        jdb.entry_offsets, max_matches=64, capacity=1 << 12,
        sw_batch=1 << 10, chain_iters=32, idx_pack=jdb.idx_pack, **kw, **jx)
    # the port joins with its sector table and tier 2, the reference
    # (prefix_rows=False, no tables passed) with its exact search
    ta = device_path.phase_a(
        torch.as_tensor(x), torch.as_tensor(b.lengths), mid, tdb.kmers,
        tdb.idx_pack, tdb.genome_chunks, tdb.entry_offsets, **kw, **tx,
        **tdb.join_tables())
    assert int(ja.overlaps.overflow) == 0
    return ja, ta


@pytest.mark.parametrize("paired,packed", [(True, True), (True, False),
                                           (False, True)])
def test_phase_a_columns_match_jax(setup, paired, packed):
    ja, ta = _phase_a_both(setup, paired, packed)
    n = ta.overlaps.read_id.shape[0]
    assert n > 0 and int(ta.overlaps.count) == int(ja.overlaps.count)
    # the reference pads the compacted set to its static SW batch
    assert not np.asarray(ja.overlaps.valid)[n:].any()
    for name in ("read_id", "entry_id", "rel_pos", "rc", "valid"):
        _eq(getattr(ta.overlaps, name), np.asarray(
            getattr(ja.overlaps, name))[:n])
    for name in ("ov_score", "ov_begin", "ov_end", "ov_qbegin", "ov_qend"):
        _eq(getattr(ta, name), np.asarray(getattr(ja, name))[:n])
    c = int(ta.pairs.count)
    assert c == int(ja.pairs.count) > 0
    for name in ta.pairs._fields[:-1]:
        _eq(getattr(ta.pairs, name)[:c], np.asarray(
            getattr(ja.pairs, name))[:c])


def _max_insert(ta):
    ins = ta.pairs.insert_size[:int(ta.pairs.count)].numpy()
    ins = ins[ins != 0].astype(np.int64)
    ins = np.where(ins >= 2**31, ins - 2**32, ins)
    return jpairing.max_allowed_insert_size_from_sizes(
        sorted(int(x) for x in ins))


def _valid_rows(b, torch_side):
    """(columns..., read_lca, group_last) of the valid rows, which both
    packages front-compact in group order."""
    def np_(x):
        return x.numpy() if torch_side else np.asarray(x)
    v = np_(b.cols.valid)
    n = int(v.sum())
    assert v[:n].all()
    cols = [np_(c)[:n].astype(np.int64) for c in b.cols]
    cols[3] &= 0xFFFFFFFF                        # combined score as uint32
    return cols + [np_(b.read_lca)[:n].astype(np.int64),
                   np_(b.group_last)[:n]]


@pytest.mark.parametrize("paired,pseudo", [(True, True), (True, False),
                                           (False, True)])
def test_phase_b_matches_jax(setup, paired, pseudo):
    taxdb, gindex, kidx, jdb, tdb, batch = setup
    ja, ta = _phase_a_both(setup, paired, packed=True)
    max_insert = min(_max_insert(ta), 2**32 - 1) if paired else 2**32 - 1
    mid = batch.midpoint if paired else 0
    n_units = batch.midpoint
    jb, _ = jdp.run_chunk_phase_b_exact(
        [ja], mid, mid, n_units, np.uint32(max_insert),
        jnp.asarray(gindex.taxonomy_ids.astype(np.int32)),
        jlca.build_device_tables(taxdb), fraction=0.95,
        perform_pseudo_assembly=pseudo, paired=paired)
    tb, _ = device_path.run_chunk_phase_b(
        [ta], mid, mid, n_units, max_insert,
        torch.as_tensor(gindex.taxonomy_ids.astype(np.int64)),
        lca.build_device_tables(taxdb, "cpu"), fraction=0.95,
        perform_pseudo_assembly=pseudo, paired=paired)
    t_rows, j_rows = _valid_rows(tb, True), _valid_rows(jb, False)
    assert len(t_rows[0]) > 0
    for a, b in zip(t_rows, j_rows):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paired", [True, False])
def test_chunk_split_over_batches_matches_jax(setup, paired):
    """process_chunk with a tiny read_batch (several device batches, one
    chunk-wide insert model and phase B) equals the reference's
    process_batch_device on the same chunk."""
    taxdb, gindex, kidx, jdb, tdb, batch = setup
    b = batch if paired else _single(batch)
    small = PipelineConfig(read_batch=16, sw_batch=1 << 10,
                           max_pairs_per_batch=1 << 12)
    jb = jrun.process_batch_device(
        b, jdb, small, jnp.asarray(gindex.taxonomy_ids.astype(np.int32)),
        jlca.build_device_tables(taxdb), want_objects=False)
    tb, _ = run.process_chunk(
        b, tdb, small, torch.as_tensor(gindex.taxonomy_ids.astype(np.int64)),
        lca.build_device_tables(taxdb, "cpu"))
    t_rows, j_rows = _valid_rows(tb, True), _valid_rows(jb, False)
    assert len(t_rows[0]) > 0
    for k in (0, 3, 4, 5, 6, 7, 8, 9, 10):      # all but the overlap ids
        np.testing.assert_array_equal(t_rows[k], j_rows[k])
    for k in (1, 2):                            # which mates are present
        np.testing.assert_array_equal(t_rows[k] >= 0, j_rows[k] >= 0)


def test_chunk_insert_model_matches_jax(setup, monkeypatch, capsys):
    """process_chunk over several device batches logs the max allowed
    insert size the JAX package's model gives over the chunk's sizes,
    and counts insert_sizes: the nonzero insert sizes of its pairs."""
    taxdb, gindex, kidx, jdb, tdb, batch = setup
    outs = []
    phase_a = device_path.phase_a

    def keep(*args, **kw):
        outs.append(phase_a(*args, **kw))
        return outs[-1]
    monkeypatch.setattr(device_path, "phase_a", keep)
    small = PipelineConfig(read_batch=16, sw_batch=1 << 10,
                           max_pairs_per_batch=1 << 12)
    metrics.reset()
    capsys.readouterr()
    run.process_chunk(
        batch, tdb, small, torch.as_tensor(gindex.taxonomy_ids.astype(
            np.int64)), lca.build_device_tables(taxdb, "cpu"))
    assert len(outs) > 1
    sizes = []
    for a in outs:
        ins = a.pairs.insert_size[:int(a.pairs.count)].numpy()
        sizes += [int(x) - 2**32 if x >= 2**31 else int(x)
                  for x in ins if x != 0]
    assert sizes
    assert metrics.counters()["insert_sizes"] == len(sizes)
    want = jpairing.max_allowed_insert_size_from_sizes(sorted(sizes))
    logged = [line.split("\t")[1] for line in
              capsys.readouterr().err.splitlines()
              if "max allowed insert size" in line]
    assert logged == [f"max allowed insert size {want}"]
