"""db/device_columns.py (the DB's columns derived on the device at load)
against the host versions and the JAX reference, bit for bit, on CPU
tensors: index_columns against join_columns, KmerIndex.prefix_table,
kslam_tpu's KmerIndex.device_arrays (words mapped to keys) and the pack
column of kslam_tpu's DeviceDB.from_index; genome_rows against
genome_chunks_from_scodes(sw_codes_np) and the JAX SW codes; the mesh
placement against shard_database(..., with_prefix=True), index_words_np
and shard_genomes.  Indexes from numpy seeds: uniform, heavy-tailed (the
99.9th-percentile branch, its percentile exactly 64 and 128), one that
fits only at a wider width, pathological (no table), empty, M at cap's
power-of-two edges, the all-ones word, a memmapped build_streamed index;
each also through staging chunks and device slices that do not divide
M.  DeviceDB.from_index and place_sharded_db with every host version
patched to raise, and the load's stages."""

import numpy as np
import pytest
import torch

from kslam_tpu.db.genbank import GenbankIndex as JGenbankIndex
from kslam_tpu.db.kmer_index import KmerIndex as JKmerIndex
from kslam_tpu.ops import encode as jencode
from kslam_tpu.pipeline import align as jalign
from kslam_tpu_torch import cli as tcli
from kslam_tpu_torch.db import device_columns, kmer_index
from kslam_tpu_torch.db.genbank import GenbankIndex
from kslam_tpu_torch.db.kmer_index import KmerIndex, join_columns
from kslam_tpu_torch.ops import encode, kmers, sw
from kslam_tpu_torch.parallel import dist
from kslam_tpu_torch.pipeline import align
from kslam_tpu_torch.utils import metrics

torch.set_num_threads(1)

U64_MAX = np.uint64(2**64 - 1)


def _columns(rng, words):
    m = len(words)
    return (np.sort(np.asarray(words, np.uint64)),
            rng.integers(0, 1 << 20, m).astype(np.int32),
            rng.integers(0, (1 << 31) - 1, m).astype(np.int32),
            rng.random(m) < 0.5)


def _grouped(rng, n_groups, size, bits, run=0):
    """n_groups groups of `size` distinct words, each group inside one
    distinct top-`bits` prefix at every width up to 26 (the words differ
    in their low 8 bits only), plus a run of `run` equal words in a
    prefix of its own."""
    prefixes = rng.choice(1 << bits, n_groups + 1, replace=False)
    shift = np.uint64(64 - bits)
    words = [(np.uint64(p) << shift) + np.arange(size, dtype=np.uint64)
             for p in prefixes[:n_groups]]
    words.append(np.full(run, np.uint64(prefixes[-1]) << shift))
    return np.concatenate(words)


def _index(case, tmp_path):
    """(KmerIndex, the prefix bits and window expected, or None)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "streamed":
        b4 = np.frombuffer(b"ACGTacgtN", np.uint8)
        entries = [(i, b4[rng.integers(0, 9, n)])
                   for i, n in enumerate((3000, 50, 7000, 1200))]
        return KmerIndex.build_streamed(iter(entries), str(tmp_path / "idx"),
                                        tmp_dir=str(tmp_path)), None
    if case == "uniform":
        words, want = rng.integers(0, U64_MAX, 5000, np.uint64,
                                   endpoint=True), None
    elif case.startswith("edge"):
        # M + 2 * window = 2^12 - 1, 2^12, 2^12 + 1 (window 8)
        m = 4096 - 16 + {"edge-1": -1, "edge0": 0, "edge+1": 1}[case]
        words, want = rng.integers(0, U64_MAX, m, np.uint64), (12, 8)
    elif case == "all_ones":
        words = np.concatenate([
            rng.integers(1, U64_MAX, 3000, np.uint64),
            np.zeros(2, np.uint64), np.full(3, U64_MAX)])
        want = None
    elif case == "heavy64":
        # 1100 prefixes of 64 and one run of 1000 at every width: the
        # percentile branch at the first width (17 bits), p999 = 64.0
        words, want = _grouped(rng, 1100, 64, 17, run=1000), (17, 64)
    elif case == "heavy128":
        words, want = _grouped(rng, 1100, 128, 18, run=1000), (18, 128)
    elif case == "wider":
        # 40 runs of 200 at the first width (13 bits), each split in
        # four runs of 50 at 15 bits
        p = rng.choice(1 << 13, 40, replace=False).astype(np.uint64)
        q, r = np.arange(4, dtype=np.uint64), np.arange(50, dtype=np.uint64)
        words = ((p[:, None, None] << np.uint64(51)) |
                 (q[None, :, None] << np.uint64(49)) |
                 r[None, None, :]).reshape(-1)
        want = (15, 64)
    elif case == "pathological":
        words = np.repeat(rng.integers(0, U64_MAX, 30, np.uint64), 200)
        want = (0, 0)
    elif case == "empty":
        words, want = np.zeros(0, np.uint64), (8, 8)
    return KmerIndex(*_columns(rng, words)), want


CASES = ["uniform", "edge-1", "edge0", "edge+1", "all_ones", "heavy64",
         "heavy128", "wider", "pathological", "empty", "streamed"]
# staging chunks of 37 keys, 74 entry ids, 296 bases and device slices
# of 333 elements: none divides M, and the ring of buffers wraps
SMALL = ["uniform", "edge+1", "all_ones", "heavy64", "streamed"]


@pytest.fixture
def small_stages(monkeypatch):
    monkeypatch.setattr(device_columns, "STAGE_BYTES", 8 * 37)
    monkeypatch.setattr(device_columns, "SLICE", 333)


def _check_index(kidx, want, got):
    keys, pack, pstart, bits, window = want
    assert keys.dtype == pack.dtype == np.int64
    np.testing.assert_array_equal(got[0].numpy(), keys)
    np.testing.assert_array_equal(got[1].numpy(), pack)
    assert got[3:] == (bits, window)
    if pstart is None:
        assert got[2] is None
    else:
        assert got[2].dtype == torch.int32
        np.testing.assert_array_equal(got[2].numpy(), pstart)


@pytest.mark.parametrize(
    "case,small", [(c, False) for c in CASES] + [(c, True) for c in SMALL],
    ids=[c for c in CASES] + [f"{c}-small-stages" for c in SMALL])
def test_index_columns_equal_host_and_jax(case, small, tmp_path,
                                          request):
    """index_columns equals join_columns (and so prefix_table), the JAX
    package's device_arrays with its words mapped to keys, and the pack
    column of its DeviceDB.from_index, bit for bit."""
    if small:
        request.getfixturevalue("small_stages")
    kidx, expect = _index(case, tmp_path)
    host = join_columns(kidx)
    if expect is not None:
        assert host[3:] == expect
    if case.startswith("heavy"):
        # the window is the 99.9th percentile of the occupied counts
        bits, window = expect
        counts = np.bincount((kidx.kmers >> np.uint64(64 - bits)).astype(
            np.int64))
        assert np.percentile(counts[counts > 0], 99.9) == window
    if case == "pathological":
        assert host[2] is None
    got = device_columns.index_columns(kidx, "cpu")
    _check_index(kidx, host, got)
    assert kidx.prefix_table()[1:] == got[3:]
    if small:
        return
    jk = JKmerIndex(np.asarray(kidx.kmers), np.asarray(kidx.entry_id),
                    np.asarray(kidx.offset), np.asarray(kidx.rc))
    km, _, _, _, jpstart, jbits, jwindow = jk.device_arrays()
    np.testing.assert_array_equal(
        got[0].numpy(), kmers.keys_from_words_np(np.asarray(km)))
    assert (jbits, jwindow) == got[3:]
    if jpstart is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jpstart))
    jg = JGenbankIndex()
    jg._bases_concat = np.frombuffer(b"ACGTN" * 7, np.uint8).copy()
    jg._offsets = np.array([0, 35], np.int64)
    jdb = jalign.DeviceDB.from_index(jg, jk, prefix_rows=False)
    np.testing.assert_array_equal(
        got[1].numpy(), np.asarray(jdb.idx_pack).view(np.int64))


def _all_bytes(rng, g):
    """g bytes cycling over all 256 values in a shuffled order."""
    return rng.permutation(np.resize(np.arange(256, dtype=np.uint8), g))


@pytest.mark.parametrize("g,flat,small", [
    (0, False, False), (1, True, False), (31, False, False),
    (32, True, False), (33, False, False), (256 * 3 + 5, True, False),
    (256 * 3 + 5, True, True), (5000, False, True)])
def test_genome_rows_equal_host_and_jax(g, flat, small, request):
    """genome_rows equals genome_chunks_from_scodes(sw_codes_np(bases))
    over all 256 byte values (the flat codes a view of the rows), and the
    JAX package's from_index codes flattened up to G; also padded to a
    longer slice length as a genome shard is."""
    if small:
        request.getfixturevalue("small_stages")
    rng = np.random.default_rng(g)
    bases = _all_bytes(rng, g)
    want = sw.genome_chunks_from_scodes(encode.sw_codes_np(bases))
    got = device_columns.genome_rows(bases, "cpu", flat=flat)
    rows = got[0] if flat else got
    assert rows.dtype == torch.uint8 and rows.shape == want.shape
    np.testing.assert_array_equal(rows.numpy(), want)
    if flat:
        np.testing.assert_array_equal(got[1].numpy(),
                                      encode.sw_codes_np(bases))
        assert got[1].data_ptr() == rows.data_ptr()
    longer = device_columns.genome_rows(bases, "cpu", length=g + 40)
    np.testing.assert_array_equal(
        longer.numpy(), sw.genome_chunks_from_scodes(
            np.concatenate([encode.sw_codes_np(bases),
                            np.full(40, 4, np.uint8)])))
    jg = JGenbankIndex()
    jg._bases_concat = bases
    jg._offsets = np.array([0, g], np.int64)
    jk = JKmerIndex(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                    np.zeros(0, np.int32), np.zeros(0, bool))
    jdb = jalign.DeviceDB.from_index(jg, jk, prefix_rows=False)
    np.testing.assert_array_equal(
        rows.numpy().reshape(-1)[:g],
        np.asarray(jdb.genome_chunks).reshape(-1)[:g])
    np.testing.assert_array_equal(rows.numpy().reshape(-1)[:g],
                                  jencode.sw_codes_np(bases))


def _mesh_index(case, rng):
    """An index whose pileups and prefix runs cross the shard cuts."""
    if case == "pileups":
        words = np.repeat(rng.integers(0, U64_MAX, 900, np.uint64),
                          rng.integers(1, 6, 900))
    elif case == "heavy":
        words = _grouped(rng, 1100, 64, 17, run=1000)
    else:   # pathological: no table
        words = np.repeat(rng.integers(0, U64_MAX, 30, np.uint64), 200)
    return KmerIndex(*_columns(rng, words))


@pytest.mark.parametrize("case,gshard,num_shards", [
    ("pileups", g, s) for g in (False, True) for s in (1, 2, 4)] + [
    (c, False, s) for c in ("heavy", "pathological") for s in (1, 2, 4)])
def test_place_sharded_db_equals_shard_database(case, gshard, num_shards):
    """Every cell of place_sharded_db holds what shard_database(kidx, S,
    with_prefix=True) + index_words_np give its index shard (keys,
    idx_pack, the clipped pstart, bits, window) and the genome rows of
    genome_chunks_from_scodes over the SW codes (all of them, or
    shard_genomes' slice and offsets); genome_layout equals
    shard_genomes' layout."""
    rng = np.random.default_rng(num_shards)
    kidx = _mesh_index(case, rng)
    lens = rng.integers(1, 700, 9)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    bases = _all_bytes(rng, int(offsets[-1]))
    scodes = encode.sw_codes_np(bases)
    km, eid, off, rc, pstart, bits, window = dist.shard_database(
        kidx, num_shards, with_prefix=True)
    assert (bits == 0) == (case == "pathological")
    mesh = dist.build_mesh(["cpu"], data=2, index=num_shards)
    sdb = dist.place_sharded_db(mesh, kidx, bases, offsets,
                                genome_sharded=gshard)
    assert (sdb.prefix_bits, sdb.prefix_window) == (bits, window)
    per = len(km) // num_shards
    j_scodes, j_offs, j_eb = dist.shard_genomes(offsets, scodes, num_shards)
    e_bounds, g_per, l_offs = dist.genome_layout(offsets, num_shards)
    np.testing.assert_array_equal(e_bounds, j_eb)
    assert g_per == len(j_scodes) // num_shards
    np.testing.assert_array_equal(l_offs.reshape(-1), j_offs)
    for s in range(num_shards):
        sl = slice(s * per, (s + 1) * per)
        keys, pack = kmer_index.index_words_np(km[sl], eid[sl], off[sl],
                                               rc[sl])
        for d in range(2):
            np.testing.assert_array_equal(sdb.kmers[d][s].numpy(), keys)
            np.testing.assert_array_equal(sdb.idx_pack[d][s].numpy(), pack)
            if bits:
                pw = len(pstart) // num_shards
                np.testing.assert_array_equal(
                    sdb.pstart[d][s].numpy(), pstart[s * pw:(s + 1) * pw])
                assert sdb.pstart[d][s].dtype == torch.int32
            else:
                assert sdb.pstart[d][s] is None
            if gshard:
                np.testing.assert_array_equal(
                    sdb.genome_chunks[d][s].numpy(),
                    sw.genome_chunks_from_scodes(
                        j_scodes[s * g_per:(s + 1) * g_per]))
                e = len(j_offs) // num_shards
                np.testing.assert_array_equal(
                    sdb.entry_offsets[d][s].numpy(), j_offs[s * e:(s + 1) * e])
            else:
                np.testing.assert_array_equal(
                    sdb.genome_chunks[d][s].numpy(),
                    sw.genome_chunks_from_scodes(scodes))
                np.testing.assert_array_equal(
                    sdb.entry_offsets[d][s].numpy(), offsets)
    if gshard:
        np.testing.assert_array_equal(sdb.e_bounds, j_eb)
    else:
        assert sdb.e_bounds is None


def _refuse(*args, **kwargs):
    raise AssertionError("a host version on the load path")


def test_load_calls_no_host_version(monkeypatch, tmp_path):
    """DeviceDB.from_index and place_sharded_db derive everything with
    join_columns, prefix_table, index_words_np, sw_codes_np,
    genome_chunks_from_scodes, shard_database and shard_genomes patched
    to raise; from_index times its four stages and the flat codes are a
    view of the genome rows."""
    kidx, _ = _index("uniform", tmp_path)
    gindex = GenbankIndex()
    gindex._bases_concat = _all_bytes(np.random.default_rng(1), 3000)
    gindex._offsets = np.array([0, 1000, 3000], np.int64)
    want = join_columns(kidx)
    rows = sw.genome_chunks_from_scodes(
        encode.sw_codes_np(gindex.bases_concat))
    for mod, name in ((kmer_index, "join_columns"),
                      (kmer_index, "index_words_np"),
                      (KmerIndex, "prefix_table"),
                      (encode, "sw_codes_np"),
                      (sw, "genome_chunks_from_scodes"),
                      (dist, "shard_database"), (dist, "shard_genomes")):
        monkeypatch.setattr(mod, name, _refuse)
    metrics.reset()
    db = align.DeviceDB.from_index(gindex, kidx, "cpu", flat_scodes=True)
    stages = metrics.summary()
    assert {"db_load_host", "db_load_h2d", "db_load_columns",
            "db_load_table"} <= set(stages)
    _check_index(kidx, want, (db.kmers, db.idx_pack, db.pstart,
                              db.prefix_bits, db.prefix_window))
    np.testing.assert_array_equal(db.genome_chunks.numpy(), rows)
    assert db.genome_scodes.data_ptr() == db.genome_chunks.data_ptr()
    assert db.genome_scodes.shape == (3000,)
    mesh = dist.build_mesh(["cpu"], data=1, index=2)
    for gshard in (False, True):
        sdb = dist.place_sharded_db(mesh, kidx, gindex.bases_concat,
                                    gindex.entry_offsets,
                                    genome_sharded=gshard)
        assert sdb.prefix_bits == want[3]


def test_cli_times_the_load_files(tmp_path):
    """run.metagenomic_analysis splits db_load's files into
    db_load_taxonomy, db_load_genomes and db_load_kmers, and
    DeviceDB.from_index's stages sit inside db_load."""
    rng = np.random.default_rng(3)
    b4 = np.frombuffer(b"ACGT", np.uint8)
    genome = b4[rng.integers(0, 4, 2000)].tobytes().decode()
    (tmp_path / "db.fasta").write_text(f">G0\n{genome}\n")
    (tmp_path / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n")
    (tmp_path / "nodes.dmp").write_text("1\t|\t1\t|\tno rank\t|\n")
    db = str(tmp_path / "DB")
    assert tcli.main(["--parse-fasta", "--output-file", db,
                      str(tmp_path / "db.fasta")]) == 0
    assert tcli.main(["--parse-taxonomy", str(tmp_path / "names.dmp"),
                      str(tmp_path / "nodes.dmp"), "--output-file",
                      db + "/taxDB"]) == 0
    read = genome[100:250]
    (tmp_path / "r.fq").write_text(f"@r0\n{read}\n+\n{'I' * 150}\n")
    metrics.reset()
    assert tcli.main(["--db", db, "--output-file", str(tmp_path / "out"),
                      "--device", "cpu", str(tmp_path / "r.fq")]) == 0
    stages = metrics.summary()
    parts = ("db_load_taxonomy", "db_load_genomes", "db_load_kmers",
             "db_load_host", "db_load_h2d", "db_load_columns",
             "db_load_table")
    assert set(parts) <= set(stages)
    assert sum(stages[k]["seconds"] for k in parts) <= \
        stages["db_load"]["seconds"] + 1e-3
