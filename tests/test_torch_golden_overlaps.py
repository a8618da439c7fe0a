"""kslam_tpu_torch.golden.overlaps (the scalar model of seeding) against
kslam_tpu's, and the port's match engine (ops/match.py) against that
model, on the reads of tests/test_match_engine.py: planted, mutated,
repeat-rich and all-A.  Exact equality (integer outputs)."""

import numpy as np
import pytest
import torch

from kslam_tpu.golden import overlaps as jgolden
from kslam_tpu_torch.db.genbank import GenbankEntry, GenbankIndex
from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.golden import overlaps as golden
from kslam_tpu_torch.ops import encode, kmers, match

torch.set_num_threads(1)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(rng, n):
    return rng.choice(BASES, n).tobytes().decode()


def planted(seed):
    """25 reads planted in 6 genomes, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    genomes = [random_seq(rng, 500) for _ in range(6)]
    reads = []
    for _ in range(25):
        g = genomes[int(rng.integers(0, len(genomes)))]
        pos = int(rng.integers(0, len(g) - 150))
        seq = g[pos:pos + 150]
        if rng.random() < 0.5:
            seq = encode.reverse_complement_str(seq)
        reads.append(seq)
    return reads, genomes


def mutated(seed):
    """Reads with up to 5 substitutions: partial k-mer sharing."""
    rng = np.random.default_rng(seed)
    genomes = [random_seq(rng, 600) for _ in range(3)]
    reads = []
    for _ in range(15):
        gid = int(rng.integers(0, len(genomes)))
        pos = int(rng.integers(0, 450))
        seq = list(genomes[gid][pos:pos + 150])
        for _ in range(int(rng.integers(0, 6))):
            seq[int(rng.integers(0, len(seq)))] = chr(int(rng.choice(BASES)))
        reads.append("".join(seq))
    return reads, genomes


def repeats(seed):
    """A tandem repeat: dedup clusters the chained |delta| < 3 rule
    decides."""
    rng = np.random.default_rng(seed)
    unit = random_seq(rng, 40)
    genome = unit * 12 + random_seq(rng, 100)
    return [genome[i:i + 150] for i in (0, 20, 40, 300)], [genome]


def all_a(seed):
    """All-A k-mers (k-mer 0) are skipped: no overlaps."""
    return ["A" * 150], ["A" * 200 + "ACGTTGCA" * 40]


CASES = {"planted": (planted, 1), "planted_2": (planted, 2),
         "mutated": (mutated, 3), "repeats": (repeats, 4),
         "all_a": (all_a, 0)}


def device_overlaps(reads, genomes):
    """The port's match engine on the reads (padded to 160 bases) against
    an index of the genomes: [(read, entry, rel_pos, rc)] of the kept
    rows."""
    gindex = GenbankIndex([GenbankEntry(bases=g) for g in genomes])
    kidx = KmerIndex.build(gindex)
    bases = np.zeros((len(reads), 160), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
        lengths[i] = len(r)
    km, off, rc, valid = kmers.read_kmers_from_codes(
        torch.as_tensor(encode.kmer_codes_np(bases)),
        torch.as_tensor(lengths))
    pack = ((kidx.entry_id.astype(np.uint64) << np.uint64(33)) |
            (kidx.offset.astype(np.uint64) << np.uint64(1)) |
            kidx.rc.astype(np.uint64)).view(np.int64)
    res = match.match_overlaps(
        km, off, rc, valid, torch.as_tensor(lengths),
        torch.as_tensor(kmers.keys_from_words_np(kidx.kmers)),
        torch.as_tensor(pack))
    assert int(res.overflow) == 0
    keep = res.valid.numpy()
    return list(zip(res.read_id.numpy()[keep].tolist(),
                    res.entry_id.numpy()[keep].tolist(),
                    res.rel_pos.numpy()[keep].tolist(),
                    res.rc.numpy()[keep].tolist()))


@pytest.mark.parametrize("case", list(CASES))
def test_golden_model_equals_reference(case):
    make, seed = CASES[case]
    reads, genomes = make(seed)
    want = jgolden.find_overlaps_golden(reads, genomes)
    assert golden.find_overlaps_golden(reads, genomes) == want
    for read in reads:
        got = golden.read_kmers_scalar(read)
        ref = jgolden.read_kmers_scalar(read)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_match_engine_equals_golden_model(case):
    make, seed = CASES[case]
    reads, genomes = make(seed)
    want = golden.find_overlaps_golden(reads, genomes)
    got = device_overlaps(reads, genomes)
    assert sorted(got) == sorted(want)
    if case != "all_a":
        assert want
    else:
        assert want == []


def test_chained_dedup_equals_reference():
    """std::unique with overlapEqual: each row against the last kept."""
    rng = np.random.default_rng(9)
    rows = sorted((int(rng.integers(0, 3)), int(rng.integers(0, 2)),
                   int(rng.integers(0, 40)), bool(rng.random() < 0.5))
                  for _ in range(300))
    rows.sort(key=lambda o: (o[0], o[1], o[2]))
    kept = golden.chained_dedup(rows)
    assert kept == jgolden.chained_dedup(rows)
    assert len(kept) < len(rows)
