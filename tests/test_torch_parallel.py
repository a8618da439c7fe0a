"""kslam_tpu_torch.parallel.dist against kslam_tpu.parallel.dist: the
numpy shard layouts (index range shards, genome entry-range slices) and
what place_sharded_db puts on each mesh cell, and the sharded alignment
step against the reference's on the 8-virtual-device CPU mesh
(tests/conftest.py): per-read best scores and the surviving row set,
exactly.  The port's mesh cells all live on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kslam_tpu.config import PipelineConfig
from kslam_tpu.db.genbank import GenbankEntry as JEntry, \
    GenbankIndex as JIndex
from kslam_tpu.db.kmer_index import KmerIndex as JKmerIndex
from kslam_tpu.ops import encode as jencode
from kslam_tpu.parallel import dist as jdist
from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.ops import kmers, sw
from kslam_tpu_torch.parallel import dist

torch.set_num_threads(1)

B4 = np.frombuffer(b"ACGT", dtype=np.uint8)


def _problem(num_genomes=4, genome_len=500, num_reads=16, read_len=100,
             pad_len=128, seed=3):
    """As tests/test_parallel.py: reads cut from random genomes, every
    third one reverse-complemented."""
    rng = np.random.default_rng(seed)
    genomes = [B4[rng.integers(0, 4, genome_len)].tobytes().decode()
               for _ in range(num_genomes)]
    comp = str.maketrans("ACGT", "TGCA")
    bases = np.zeros((num_reads, pad_len), dtype=np.uint8)
    for i in range(num_reads):
        g = genomes[i % num_genomes]
        pos = int(rng.integers(0, genome_len - read_len))
        r = g[pos:pos + read_len]
        if i % 3 == 0:
            r = r.translate(comp)[::-1]
        bases[i, :read_len] = np.frombuffer(r.encode(), np.uint8)
    return genomes, bases, np.full(num_reads, read_len, np.int32)


def _indexes(genomes, lengths=None):
    jg = JIndex([JEntry(bases=g, taxonomy_id=0, locus_tag=f"G{i}")
                 for i, g in enumerate(genomes)])
    jk = JKmerIndex.build(jg)
    return jg, jk, KmerIndex(jk.kmers, jk.entry_id, jk.offset, jk.rc)


def test_build_mesh_cycles_cells_over_devices():
    devs = [torch.device("cuda", i) for i in range(3)]
    mesh = dist.build_mesh(devs, data=2, index=4)
    assert mesh.shape == {"data": 2, "index": 4}
    flat = [d for row in mesh.devices for d in row]
    assert flat == [devs[i % 3] for i in range(8)]
    assert mesh.distinct() == devs
    assert dist.build_mesh(devs).shape == {"data": 1, "index": 3}
    cpu = dist.build_mesh(["cpu"], data=2, index=2)
    assert cpu.distinct() == [torch.device("cpu")]


@pytest.mark.parametrize("num_shards", [1, 2, 3, 8])
def test_shard_layouts_equal_jax(num_shards):
    """shard_database / shard_genomes equal the reference's arrays, and
    each cell of place_sharded_db holds its shard's key-encoded index
    (the reference's padded shard), its clipped prefix table and its
    genome."""
    rng = np.random.default_rng(num_shards)
    lens = rng.integers(200, 900, 7)
    genomes = [B4[rng.integers(0, 4, n)].tobytes().decode() for n in lens]
    # a repeat shared by every genome makes pileups for the shard cuts
    genomes = [g[:100] + genomes[0][:150] + g[100:] for g in genomes]
    jg, jk, tk = _indexes(genomes)
    assert np.array_equal(tk.shard_bounds(num_shards),
                          jk.shard_bounds(num_shards))
    for got, want in zip(dist.shard_database(tk, num_shards),
                         jdist.shard_database(jk, num_shards)):
        np.testing.assert_array_equal(got, want)
    scodes = jencode.sw_codes_np(jg.bases_concat)
    for got, want in zip(dist.shard_genomes(jg.entry_offsets, scodes,
                                            num_shards),
                         jdist.shard_genomes(jg.entry_offsets, scodes,
                                             num_shards)):
        np.testing.assert_array_equal(got, want)

    jkm, jeid, joff, jrc, jpstart, bits, window = jdist.shard_database(
        jk, num_shards, with_prefix=True)
    for got, want in zip(dist.shard_database(tk, num_shards,
                                             with_prefix=True),
                         (jkm, jeid, joff, jrc, jpstart, bits, window)):
        np.testing.assert_array_equal(got, want)
    assert bits > 0 and window > 0
    per = len(jkm) // num_shards
    pw = len(jpstart) // num_shards
    for gshard in (False, True):
        mesh = dist.build_mesh(["cpu"], data=2, index=num_shards)
        sdb = dist.place_sharded_db(mesh, tk, jg.bases_concat, jg.entry_offsets,
                                    genome_sharded=gshard)
        j_scodes, j_offs, j_eb = jdist.shard_genomes(
            jg.entry_offsets, scodes, num_shards)
        for s in range(num_shards):
            # the padded shard (sentinel keys, zero words in the tail) and
            # its clipped prefix table
            sl = slice(s * per, (s + 1) * per)
            np.testing.assert_array_equal(
                sdb.kmers[1][s].numpy(), kmers.keys_from_words_np(jkm[sl]))
            assert sdb.kmers[1][s][-1] == 2**63 - 1
            pack = sdb.idx_pack[0][s].numpy().view(np.uint64)
            np.testing.assert_array_equal(pack >> np.uint64(33), jeid[sl])
            np.testing.assert_array_equal(
                (pack >> np.uint64(1)) & np.uint64(0xFFFFFFFF), joff[sl])
            np.testing.assert_array_equal(pack & np.uint64(1), jrc[sl])
            np.testing.assert_array_equal(sdb.pstart[0][s].numpy(),
                                          jpstart[s * pw:(s + 1) * pw])
            assert (sdb.prefix_bits, sdb.prefix_window) == (bits, window)
            # one tensor per (shard, device): both data rows share it
            assert sdb.kmers[0][s] is sdb.kmers[1][s]
            assert sdb.pstart[0][s] is sdb.pstart[1][s]
            if gshard:
                g = len(j_scodes) // num_shards
                np.testing.assert_array_equal(
                    sdb.genome_chunks[0][s].numpy(),
                    sw.genome_chunks_from_scodes(j_scodes[s * g:(s + 1) * g]))
                e = len(j_offs) // num_shards
                np.testing.assert_array_equal(
                    sdb.entry_offsets[0][s].numpy(),
                    j_offs[s * e:(s + 1) * e])
            else:
                assert sdb.genome_chunks[0][s] is sdb.genome_chunks[1][0]
                np.testing.assert_array_equal(
                    sdb.genome_chunks[0][s].numpy(),
                    sw.genome_chunks_from_scodes(scodes))
        if gshard:
            np.testing.assert_array_equal(sdb.e_bounds, j_eb)
        else:
            assert sdb.e_bounds is None


def _row_set(read_id, entry_id, rel_pos, rc, valid, score):
    rows = set()
    for v, r, e, p, c, s in zip(valid, read_id, entry_id, rel_pos, rc,
                                score):
        if v:
            rows.add((int(r), int(e), int(p), bool(c), int(s)))
    return rows


@pytest.mark.parametrize("data,index", [(2, 4), (1, 8), (4, 2)])
def test_sharded_align_step_equals_jax(data, index):
    if len(jax.devices()) < data * index:
        pytest.skip("needs 8 virtual devices")
    config = PipelineConfig()
    genomes, bases, lengths = _problem(num_reads=4 * data)
    jg, jk, tk = _indexes(genomes)
    jmesh = jdist.build_mesh(jax.devices()[:data * index], data=data,
                             index=index)
    km, eid, off, rc = jdist.shard_database(jk, index)
    jstep = jdist.make_sharded_align_step(jmesh, config, capacity=1 << 10,
                                          window_len=bases.shape[1])
    jout = jstep(jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(km),
                 jnp.asarray(eid), jnp.asarray(off), jnp.asarray(rc),
                 jnp.asarray(jencode.sw_codes_np(jg.bases_concat)),
                 jnp.asarray(jg.entry_offsets))

    mesh = dist.build_mesh(["cpu"], data=data, index=index)
    sdb = dist.place_sharded_db(mesh, tk, jg.bases_concat,
                                jg.entry_offsets)
    step = dist.make_sharded_align_step(mesh, config,
                                        window_len=bases.shape[1])
    out = step(bases, lengths, sdb)

    np.testing.assert_array_equal(out.best_score.numpy(),
                                  np.asarray(jout.best_score))
    assert int(out.best_score.max()) > 0
    want = set()
    for d in range(data):
        for s in range(index):
            want |= _row_set(*(np.asarray(getattr(jout, f))[d, s] for f in
                               ("read_id", "entry_id", "rel_pos", "rc",
                                "valid", "score")))
    got = set()
    for d in range(data):
        for s in range(index):
            got |= _row_set(*(getattr(out, f)[d][s].numpy() for f in
                              ("read_id", "entry_id", "rel_pos", "rc",
                               "valid", "score")))
    assert got == want and len(got) > 0
