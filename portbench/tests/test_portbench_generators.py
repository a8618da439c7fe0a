"""The generators are deterministic per seed, and the device index sort
gives KmerIndex.build's order."""

import numpy as np
import torch

from portbench.gen import genomes, index, reads
from portbench.tests import tiny


def _make(seed):
    cfg, tr = tiny.config(), tiny.traffic("host-rich", pairs=512)
    db = genomes.make_db(cfg["db"], seed, torch.device("cpu"))
    r1, r2, kind, g = reads.make_reads(db, tr, seed, torch.device("cpu"))
    return db, (r1, r2, kind, g)


def test_generators_deterministic_per_seed():
    a_db, a_r = _make(2**31 + 17)
    b_db, b_r = _make(2**31 + 17)
    c_db, c_r = _make(5)
    assert torch.equal(a_db["bases"], b_db["bases"])
    assert np.array_equal(a_db["offsets"], b_db["offsets"])
    for x, y in zip(a_r, b_r):
        assert torch.equal(x, y)
    assert all(np.array_equal(s1, s2) and np.array_equal(t1, t2)
               for (s1, t1), (s2, t2) in zip(a_db["genes"], b_db["genes"]))
    assert not torch.equal(a_db["bases"], c_db["bases"])
    assert not torch.equal(a_r[0], c_r[0])


def test_same_sizes_for_every_seed():
    """Each seed gets the same counts of database, novel and host pairs."""
    _, (_, _, k1, _) = _make(1)
    _, (_, _, k2, _) = _make(2)
    assert torch.equal(torch.bincount(k1.long()), torch.bincount(k2.long()))


def test_index_sort_equals_kmerindex_build():
    from kslam_tpu_torch.db.genbank import GenbankEntry, GenbankIndex
    from kslam_tpu_torch.db.kmer_index import KmerIndex
    cfg = tiny.config()
    cfg["db"].update(genomes=6, genome_bp=60_000)
    db = genomes.make_db(cfg["db"], 3, torch.device("cpu"))
    bases = db["bases"].numpy()
    off = db["offsets"]
    gi = GenbankIndex([GenbankEntry(bases=bases[off[i]:off[i + 1]]
                                    .tobytes().decode(),
                                    taxonomy_id=int(t))
                       for i, t in enumerate(db["taxids"])])
    want = KmerIndex.build(gi, 16)
    got = index.build(db["bases"], off, 16, block=1 << 12)
    for g, w in zip(got, (want.kmers, want.entry_id, want.offset, want.rc)):
        assert np.array_equal(g, w)
