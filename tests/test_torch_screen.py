"""Host and low-complexity screening of kslam_tpu_torch (ops/screen.py)
against the JAX reference (kslam_tpu.ops.screen): each step on seeded
reads with planted host reads, low-complexity and short reads, the
float32 per-read cutoffs at every length 0..1024, and the CLI with
--host-screen (a table built by --build-host-table) and
--low-complexity-cutoff.  Integer outputs: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kslam_tpu.db.host_table import HostTable as JHostTable
from kslam_tpu.ops import encode as jencode, screen as jscreen
from kslam_tpu_torch import cli as tcli
from kslam_tpu_torch.db.genbank import GenbankEntry, GenbankIndex
from kslam_tpu_torch.db.host_table import HostTable
from kslam_tpu_torch.ops import encode, screen
from tests import torch_cli_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reads():
    """ASCII [N, 160] reads: host slices, mutated host slices, random,
    low-complexity, short and N-containing reads; and the host table."""
    rng = np.random.default_rng(21)
    host = fx.B4[rng.integers(0, 4, 3000)].tobytes().decode()
    seqs = []
    for k in range(40):
        p = int(rng.integers(0, 3000 - 150))
        r = list(host[p:p + 150])
        for q in rng.integers(0, 150, k % 12):      # 0..11 mutations
            r[q] = "ACGT"[int(rng.integers(0, 4))]
        seqs.append("".join(r)[:100 + k])
    seqs += [fx.B4[rng.integers(0, 4, 150)].tobytes().decode()
             for _ in range(10)]
    seqs += ["ACACACACAC" * 15, "A" * 150, "ACGTACGTAC", "ACGTTGCA" * 2,
             host[500:650].replace("G", "N", 3)]
    bases = np.zeros((len(seqs), 160), np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        bases[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
        lengths[i] = len(s)
    table = HostTable.build(GenbankIndex([GenbankEntry(bases=host)]),
                            kind="sorted")
    return bases, lengths, table


def _codes(bases):
    return (encode.kmer_codes(torch.as_tensor(bases)),
            jencode.kmer_codes(jnp.asarray(bases)))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


def test_kmer16_and_distinct_3mers_match_jax(reads):
    bases, lengths, _ = reads
    tc, jc = _codes(bases)
    tk, tv = screen.kmer16_canonical(tc, torch.as_tensor(lengths))
    jk, jv = jscreen.kmer16_canonical(jc, jnp.asarray(lengths))
    _eq(tk, jk)
    _eq(tv, jv)
    n3 = screen.distinct_3mer_count(tc, torch.as_tensor(lengths))
    _eq(n3, jscreen.distinct_3mer_count(jc, jnp.asarray(lengths)))
    assert int(n3.min()) < 10 and int(n3.max()) > 50


@pytest.mark.parametrize("gap", [1, 3, 8, 200])
def test_chain_top2_matches_jax(gap):
    rng = np.random.default_rng(gap)
    found = rng.random((64, 145)) < np.linspace(0.05, 0.98, 64)[:, None]
    t_out = screen.chain_top2(torch.as_tensor(found), gap)
    j_out = jscreen.chain_top2(jnp.asarray(found), gap)
    for t, j in zip(t_out, j_out):
        _eq(t, j)
    if gap < 145:
        assert int(t_out[0].max()) >= 3 and int(t_out[2].max()) >= 3


def test_table_lookups_match_jax(reads):
    """Both lookups against JAX; the bitset on a small word array with the
    k-mers kept inside its range, and equal to the sorted lookup of the
    same set."""
    _, _, table = reads
    rng = np.random.default_rng(5)
    kmers = np.concatenate([table.data[rng.integers(0, len(table.data),
                                                    200)],
                            rng.integers(0, 2**32, 200).astype(np.uint32)])
    t_hit = screen.table_lookup_sorted(
        torch.as_tensor(kmers.astype(np.int64)),
        screen.table_tensor(table, "cpu"))
    _eq(t_hit, jscreen.table_lookup_sorted(jnp.asarray(kmers),
                                           jnp.asarray(table.data)))
    assert int(t_hit.sum()) >= 200
    n_words = 1 << 12
    members = rng.integers(0, 32 * n_words, 3000).astype(np.uint32)
    words = np.zeros(n_words, np.uint32)
    np.bitwise_or.at(words, (members >> 5).astype(np.int64),
                     np.uint32(1) << (members & np.uint32(31)))
    probe = np.concatenate([members[:500], rng.integers(
        0, 32 * n_words, 500).astype(np.uint32)])
    bit = HostTable("bitset", words)
    t_bit = screen.table_lookup_bitset(
        torch.as_tensor(probe.astype(np.int64)),
        screen.table_tensor(bit, "cpu"))
    _eq(t_bit, jscreen.table_lookup_bitset(jnp.asarray(probe),
                                           jnp.asarray(words)))
    uniq = np.unique(members)
    _eq(t_bit, screen.table_lookup_sorted(
        torch.as_tensor(probe.astype(np.int64)),
        torch.as_tensor(uniq.astype(np.int64))))


def test_screen_reads_matches_jax(reads):
    bases, lengths, table = reads
    t_host, t_n3 = screen.screen_reads(
        torch.as_tensor(bases), torch.as_tensor(lengths),
        screen.table_tensor(table, "cpu"))
    j_host, j_n3 = jscreen.screen_reads(
        jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(table.data))
    _eq(t_host, j_host)
    _eq(t_n3, j_n3)
    # exact host slices (the N-containing one too) are host; random,
    # low-complexity and short reads are not
    assert bool(t_host[0]) and bool(t_host[-1]) and not t_host[40:-1].any()
    assert 5 < int(t_host.sum()) < 40


def test_cutoffs_every_length_match_jax():
    """floor(a*len + b) in float32 for len 0..1024, against the JAX
    expression as screen_reads writes it and a two-rounding numpy
    float32 model (an FMA contraction would move boundary lengths)."""
    lengths = np.arange(1025, dtype=np.int32)
    flen_t = torch.as_tensor(lengths).to(torch.float32)

    @jax.jit
    def jax_cutoffs(lens):
        flen = lens.astype(jnp.float32)
        return (jnp.floor(0.09 * flen + 1.1).astype(jnp.int32),
                jnp.floor(0.082 * flen + 3.04).astype(jnp.int32),
                jnp.floor(0.1 * flen + 26).astype(jnp.int32))

    f32 = lengths.astype(np.float32)
    for (a, b), j in zip(((0.09, 1.1), (0.082, 3.04), (0.1, 26.0)),
                         jax_cutoffs(jnp.asarray(lengths))):
        got = screen._cutoff(flen_t, a, b).numpy()
        np.testing.assert_array_equal(got, np.asarray(j))
        model = np.floor(f32 * np.float32(a) + np.float32(b))
        np.testing.assert_array_equal(got, model.astype(np.int32))


def test_host_table_build_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    fa = tmp_path / "host.fa"
    fa.write_text(">H\n" + fx.B4[rng.integers(0, 4, 2000)].tobytes()
                  .decode() + "\n")
    assert tcli.main(["--build-host-table", "--output-file",
                      str(tmp_path / "T"), str(fa)]) == 0
    mine = HostTable.load(str(tmp_path / "T"))
    ref = JHostTable.build(fx.index_from_fasta([str(fa)]))
    assert mine.kind == ref.kind == "sorted"
    np.testing.assert_array_equal(mine.data, ref.data)


@pytest.fixture(scope="module")
def genbank(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_screen_cli")
    db = fx.genbank_db(root)
    # the host genome is GEN_A.1 (taxid 562), the first entry of db.fa
    lines = (root / "db.fa").read_text().split("\n")
    (root / "host.fa").write_text("\n".join(lines[:2]) + "\n")
    assert tcli.main(["--build-host-table", "--output-file",
                      str(root / "HOST"), str(root / "host.fa")]) == 0
    return root, db


def test_cli_host_screen_matches_jax(genbank):
    root, db = genbank
    flags = ["--host-screen", str(root / "HOST"),
             "--low-complexity-cutoff", "40"]
    t_files, j_files = fx.compare_files(root, db, "screen", flags,
                                        single=False)
    assert t_files == j_files
    taxa = {line.split("\t")[1] for line in t_files["_PerRead"].split("\n")
            if line}
    assert "1280" in taxa and "562" not in taxa      # host pairs dropped
